"""K5: the per-row fractional shear as one hand-written CUDA kernel
(`csrc/warp.cu`).

Replaces the TPU kernel `yolox_tpu/ops/pallas_warp.py::_shear_kernel` and
implements the contract of its scan reference, `shear_x_reference`: each
row shifts by its own s, k = clamp(floor(s), 0, W - out_w - 2) and
f = s - k, unclamped, so a shift outside [0, k_max + 1] extrapolates. The
Pallas kernel's limit of 3 pixels of shift spread per 8-row group was a
TPU limit and is gone.

Bound on an H100: bytes (each output value reads a window of its row and
writes once; four float operations per value). One thread per output
value, coalesced along the row, lerp in float32 without FMA contraction:
bit-equal to `shear_x_plain` in float32 and bf16.

`shear_x` launches the kernel for CUDA tensors and runs the plain PyTorch
version, `shear_x_plain`, only for CPU tensors.
"""

from __future__ import annotations

import torch

from yolox_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}


def _check(img: torch.Tensor, shifts: torch.Tensor, out_w: int, px: int):
    """(k_max, out row length) of a valid call; ValueError otherwise."""
    if img.dim() != 3 or px < 1 or img.shape[2] % px:
        raise ValueError(f"shear_x: want img (B, H, W*px) with px = {px}, "
                         f"got {tuple(img.shape)}")
    if tuple(shifts.shape) != tuple(img.shape[:2]):
        raise ValueError(f"shear_x: want shifts {tuple(img.shape[:2])}, got "
                         f"{tuple(shifts.shape)}")
    w = img.shape[2] // px
    if w < out_w + 2:
        raise ValueError(f"shear_x: W = {w} < out_w + 2 = {out_w + 2}")
    return w - out_w - 2, out_w * px


def shear_x_plain(img: torch.Tensor, shifts: torch.Tensor, out_w: int,
                  px: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K5: out[b, i, (j, c)] = lerp of
    img[b, i, (j + k, c)] and img[b, i, (j + k + 1, c)] by f, with
    k = clamp(floor(s), 0, W - out_w - 2) and f = s - k for s =
    shifts[b, i]. img (B, H, W*px) float, shifts (B, H) float32; returns
    (B, H, out_w*px) in img's dtype, the lerp in float32 (float64 for
    float64 images)."""
    k_max, out_wl = _check(img, shifts, out_w, px)
    cdt = torch.float64 if img.dtype == torch.float64 else torch.float32
    s = shifts.to(cdt)
    k = torch.floor(s).clamp(0, k_max)
    f = (s - k)[..., None]
    cols = (k.long() * px)[..., None] + torch.arange(out_wl,
                                                     device=img.device)
    a = torch.gather(img, 2, cols).to(cdt)
    b = torch.gather(img, 2, cols + px).to(cdt)
    return (a * (1.0 - f) + b * f).to(img.dtype)


def shear_x(img: torch.Tensor, shifts: torch.Tensor, out_w: int,
            px: int = 1) -> torch.Tensor:
    """out[b, i, (j, c)] = img[b, i, (j + shifts[b, i], c)], two-tap
    linear, over rows of px channel-interleaved values per pixel.
    img (B, H, W*px) float32 or bf16, contiguous on CUDA; shifts (B, H)
    float32; W >= out_w + 2. Returns (B, H, out_w*px) in img's dtype."""
    if img.device.type == "cpu":
        return shear_x_plain(img, shifts, out_w, px)
    if img.device.type != "cuda":
        raise ValueError(f"shear kernel: unsupported device {img.device}")
    k_max, out_wl = _check(img, shifts, out_w, px)
    if img.dtype not in _DTYPE_CODES:
        raise ValueError(f"shear kernel: img must be float32 or bfloat16, "
                         f"got {img.dtype}")
    if shifts.dtype != torch.float32 or shifts.device != img.device:
        raise ValueError("shear kernel: shifts must be float32 on the "
                         "image's device")
    if not (img.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("shear kernel: inputs must be contiguous")
    b, h, wl = img.shape
    out = torch.empty((b, h, out_wl), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    _build.launch(_build.load("warp").yolox_shear_x, img.device,
                  "shear kernel", img.data_ptr(), shifts.data_ptr(),
                  out.data_ptr(), b * h, wl, out_wl, px, k_max,
                  _DTYPE_CODES[img.dtype])
    shear_x.launches += 1
    return out


shear_x.launches = 0
