"""Native (C++) host routines, built on demand with g++ and loaded with
ctypes: the port's copy of the JAX package's `yolox_tpu/native`.

`cocoeval.cpp` is the COCO matching routine of `evaluators/cocoeval.py`.
One g++ call builds it at first use into `yolox_tpu_torch/_build/`
(git-ignored), named by a hash of the source, so an edited source is
rebuilt. Processes that build at once (test workers, ranks) are
serialized by an exclusive lock file beside the library. Without a
compiler, or when the build or the load fails, the evaluator runs its
pure-python matching, which gives the same numbers; `COCOeval.matcher`
says which of the two ran.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from yolox_tpu_torch.utils.logger import logger

_SRC = Path(__file__).resolve().parent / "cocoeval.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return BUILD_DIR / f"libcocoeval_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.warning(f"native cocoeval build failed ({e}); using the "
                       "python matching")
        return False
    os.replace(tmp, out)
    return True


def load_cocoeval_lib() -> Optional[ctypes.CDLL]:
    """Build (once) and load the cocoeval routine; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True

    out = _lib_path()
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists() and not _build(out):
                return None
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        logger.warning(f"native cocoeval load failed ({e}); using the "
                       "python matching")
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cocoeval_evaluate.restype = None
    lib.cocoeval_evaluate.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p,          # groups
        f64p,                                       # dt_areas
        f64p, u8p, u8p, f64p,                       # gts + ious
        ctypes.c_int64, f64p,                       # thresholds
        ctypes.c_int64, f64p,                       # area ranges
        ctypes.c_int64,                             # max_det
        i64p, i64p, u8p, u8p, u8p,                  # outputs
    ]
    _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def cocoeval_evaluate_native(dt_off, gt_off, iou_off, dt_areas, gt_areas,
                             gt_iscrowd, gt_ignore_base, ious, iou_thrs,
                             area_rngs, max_det):
    """ctypes wrapper; returns (dt_matched, dt_ignored, gt_ignored,
    out_dt_off, out_gt_off). See cocoeval.cpp for the layout."""
    lib = load_cocoeval_lib()
    assert lib is not None

    n_groups = len(dt_off) - 1
    n_area = len(area_rngs)
    n_thr = len(iou_thrs)

    dt_counts = np.minimum(np.diff(dt_off), max_det)
    gt_counts = np.diff(gt_off)
    # block r = g * n_area + a: group g's counts, repeated for each area
    out_dt_off = np.concatenate(
        [[0], np.cumsum(np.repeat(dt_counts, n_area))]).astype(np.int64)
    out_gt_off = np.concatenate(
        [[0], np.cumsum(np.repeat(gt_counts, n_area))]).astype(np.int64)

    dt_matched = np.zeros(int(out_dt_off[-1]) * n_thr, np.uint8)
    dt_ignored = np.zeros(int(out_dt_off[-1]) * n_thr, np.uint8)
    gt_ignored = np.zeros(int(out_gt_off[-1]), np.uint8)

    c = np.ascontiguousarray
    area_rngs = np.asarray(area_rngs, np.float64).reshape(-1)
    lib.cocoeval_evaluate(
        ctypes.c_int64(n_groups),
        _ptr(c(dt_off, np.int64), ctypes.c_int64),
        _ptr(c(gt_off, np.int64), ctypes.c_int64),
        _ptr(c(iou_off, np.int64), ctypes.c_int64),
        _ptr(c(dt_areas, np.float64), ctypes.c_double),
        _ptr(c(gt_areas, np.float64), ctypes.c_double),
        _ptr(c(gt_iscrowd, np.uint8), ctypes.c_uint8),
        _ptr(c(gt_ignore_base, np.uint8), ctypes.c_uint8),
        _ptr(c(ious, np.float64), ctypes.c_double),
        ctypes.c_int64(n_thr),
        _ptr(c(iou_thrs, np.float64), ctypes.c_double),
        ctypes.c_int64(n_area),
        _ptr(c(area_rngs, np.float64), ctypes.c_double),
        ctypes.c_int64(max_det),
        _ptr(out_dt_off, ctypes.c_int64),
        _ptr(out_gt_off, ctypes.c_int64),
        _ptr(dt_matched, ctypes.c_uint8),
        _ptr(dt_ignored, ctypes.c_uint8),
        _ptr(gt_ignored, ctypes.c_uint8),
    )
    return dt_matched, dt_ignored, gt_ignored, out_dt_off, out_gt_off
