"""Build the hand-written CUDA kernels under `csrc/` and load them.

Each `csrc/<name>.cu` exposes a plain C launcher (no PyTorch headers), so
`nvcc` builds it in seconds into a shared library that `ctypes` loads.
Libraries go to `yolox_tpu_torch/_build/` (git-ignored), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built when the package is imported:
the first launch of a kernel builds it, or `build_all()` builds every
kernel at once with one `nvcc` per source running in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("stem", "nms")

# No --use_fast_math: the NMS kernel's IoU must round exactly like the
# PyTorch plain version, and the stem's epilogue keeps IEEE expf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels of yolox_tpu_torch "
        "are built on first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start_build(name: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, build) -> None:
    proc, tmp, out = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file


def build_all() -> None:
    """Build every missing kernel library, one `nvcc` per source, all
    started together."""
    builds = {n: _start_build(n) for n in KERNELS if not _lib_path(n).exists()}
    errors = []
    for n, build in builds.items():
        try:
            _finish_build(n, build)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero `cudaError_t` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
