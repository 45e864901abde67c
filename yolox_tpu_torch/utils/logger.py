"""Logging setup, the port's copy of the JAX package's
`yolox_tpu/utils/logger.py` (the reference's `yolox/utils/logger.py:32-113`).

The reference uses loguru with stdout/stderr redirection so third-party
prints (pycocotools chatter etc.) become log records; we use the stdlib
logging module with the same surface: `setup_logger(save_dir, rank,
filename)` logs to stderr + file on rank 0 only, and `capture_std=True`
(off by default; the trainer passes it) routes
sys.stdout/sys.stderr writes into the logger — and therefore into the
log file.
"""

from __future__ import annotations

import io
import logging
import os
import sys

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s:%(lineno)d - %(message)s"

logger = logging.getLogger("yolox_tpu_torch")


class _StreamToLogger:
    """File-like object that turns writes into log records (the reference's
    `StreamToLoguru`, `logger.py:32-58`)."""

    def __init__(self, level: int = logging.INFO):
        self.level = level
        self._buf = ""

    def write(self, text):
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.strip():
                logger.log(self.level, line.rstrip())
        return len(text)

    def flush(self):
        if self._buf.strip():
            logger.log(self.level, self._buf.rstrip())
        self._buf = ""

    def isatty(self):
        return False

    def fileno(self):
        # no real descriptor backs this stream; raising the io-standard
        # error lets probing code (subprocess, tqdm) fall back cleanly
        # instead of writing past the logger
        raise io.UnsupportedOperation("fileno")

    def writable(self):
        return True

    def close(self):
        # file-like protocol completeness: pytest/interpreter teardown may
        # close() whatever sits in sys.stdout — flush, never raise
        self.flush()


_saved_streams = {}


def redirect_sys_output(level: int = logging.INFO):
    """Route sys.stdout/sys.stderr through the logger (idempotent). The
    logger's own handlers keep the real streams they captured at setup."""
    for name in ("stdout", "stderr"):
        if not isinstance(getattr(sys, name), _StreamToLogger):
            _saved_streams[name] = getattr(sys, name)
            setattr(sys, name, _StreamToLogger(level))


def restore_sys_output():
    """Undo redirect_sys_output, restoring the exact streams it replaced."""
    for name in ("stdout", "stderr"):
        if isinstance(getattr(sys, name), _StreamToLogger):
            setattr(sys, name,
                    _saved_streams.pop(name, getattr(sys, f"__{name}__")))


def setup_logger(save_dir: str = None, rank: int = 0,
                 filename: str = "log.txt", mode: str = "a",
                 capture_std: bool = False):
    """Configure the package logger. Rank-0 writes to stderr + file; other
    ranks are silenced (matching `logger.py:96-113`). With `capture_std`,
    raw prints are captured as log records (matching `logger.py:61-78`) —
    the trainer enables it so third-party chatter lands in its log
    file; pair with `restore_sys_output()` when embedding.
    """
    root = logging.getLogger("yolox_tpu_torch")
    root.handlers.clear()
    root.setLevel(logging.INFO)
    if rank != 0:
        root.addHandler(logging.NullHandler())
        root.propagate = False
        return root

    # bind the handler to the REAL stderr before any redirection, so
    # captured prints don't recurse through the wrapper
    real_stderr = (sys.stderr if not isinstance(sys.stderr, _StreamToLogger)
                   else sys.__stderr__)
    sh = logging.StreamHandler(real_stderr)
    sh.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
    root.addHandler(sh)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, filename)
        if mode == "o" and os.path.exists(path):
            os.remove(path)
        fh = logging.FileHandler(path)
        fh.setFormatter(
            logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        root.addHandler(fh)
    root.propagate = False
    if capture_std:
        redirect_sys_output()
    return root
