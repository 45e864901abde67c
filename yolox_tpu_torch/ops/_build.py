"""Build the hand-written CUDA kernels under `csrc/` and load them.

Each `csrc/<name>.cu` exposes a plain C launcher (no PyTorch headers), so
`nvcc` builds it in seconds into a shared library that `ctypes` loads.
Libraries go to `yolox_tpu_torch/_build/` (git-ignored), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built when the package is imported:
the first launch of a kernel builds it, or `build_all()` builds every
kernel at once with one `nvcc` per source running in parallel.

Each launcher's ctypes signature is bound once, when its library is first
loaded (`SIGNATURES`), and `launch` calls it on the tensors' device and
current stream, so a kernel call costs the wrapper a few microseconds.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("stem", "nms", "conv_bwd", "warp", "int8_conv")

# No --use_fast_math: the NMS kernel's IoU and the shear's lerp must round
# exactly like their PyTorch plain versions, the stem's epilogue and the
# conv backward's float32 one keep IEEE expf (its bf16 one takes the
# SFU's, see csrc/conv_bwd.cu), and the int8 convs' epilogue its IEEE
# divide and float64 exp.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher name -> argument types, per library; every launcher returns a
# cudaError_t as int. Pointers and the stream are c_void_p: a plain int
# would be cut to 32 bits.
SIGNATURES = {
    "stem": {"yolox_stem_conv_bn_act": [_P, _I, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _P]},
    # K2: one packed argument struct (`nms_kernel._ARGS`)
    "nms": {"yolox_nms_keep": [ctypes.c_char_p, _P]},
    # K3 / K4: one packed argument struct (`conv_bwd._K3_ARGS`, `_K4_ARGS`)
    "conv_bwd": {"yolox_bn_silu_reduce": [ctypes.c_char_p, _P],
                 "yolox_conv1x1_bn_silu_bwd": [ctypes.c_char_p, _P]},
    "warp": {"yolox_shear_x": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
             "yolox_shear_xy": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P]},
    # Q1 / Q2: (x, w, scale, bias, out_scale, out, out_kind, B, H, W, Cin,
    # [Cout,] k, stride, act, the plan's choices, stream); the setup call
    # of a device
    "int8_conv": {"yolox_int8_conv": [_P] * 6 + [_I] * 16 + [_P],
                  "yolox_int8_dwconv": [_P] * 6 + [_I] * 12 + [_P],
                  "yolox_int8_init": [],
                  "yolox_int8_epilogue_mismatches": [_P, _P]},
}

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
    """The library of `csrc/<name>.cu`, named by a hash of that source, of
    every header under `csrc/` (any of them may be included) and of the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
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
    """The loaded kernel library `name` with its launchers' signatures
    bound, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = argtypes
            _loaded[name] = lib
        return lib


def stream(device: torch.device) -> int:
    """The handle of CUDA `device`'s current stream (`cudaStream_t` as an
    int), without building a `torch.cuda.Stream` object: ~0.2 us a call
    against ~4 us on an H100 host."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(fn, device: torch.device, what: str, *args) -> None:
    """fn(*args, stream) with the current stream of CUDA `device`, made
    the current device only when it is not already; raises when the
    launcher returns a CUDA error."""
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream(device))
    check(err, what)


def check(err: int, what: str) -> None:
    """Raise on a nonzero `cudaError_t` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
