"""K5: the per-row fractional shear as hand-written CUDA kernels
(`csrc/warp.cu`).

Replaces the TPU kernel `yolox_tpu/ops/pallas_warp.py::_shear_kernel` and
implements the contract of its scan reference, `shear_x_reference`: each
row shifts by its own s, k = clamp(floor(s), 0, W - out_w - 2) and
f = s - k, unclamped, so a shift outside [0, k_max + 1] extrapolates. The
Pallas kernel's limit of 3 pixels of shift spread per 8-row group was a
TPU limit and is gone.

Bound on an H100: bytes (four float operations a value). `shear_xy` is
the warp's: both shear passes and the transpose between them in one
launch, the intermediate h2 kept in shared memory, 16-byte loads and
stores. `shear_x` is one pass, one thread per output value. Both lerp in
float32 without FMA contraction: bit-equal to `shear_xy_plain` /
`shear_x_plain` in float32 and bf16.

The wrappers launch the kernels for CUDA tensors and run the plain
PyTorch versions only for CPU tensors.
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


def _check_xy(h1t, shifts_y, shifts_x, out_w: int, px: int):
    """(B, X, R) of a valid `shear_xy` call; ValueError otherwise."""
    if h1t.dim() != 3 or px < 1 or h1t.shape[2] % px:
        raise ValueError(f"shear_xy: want h1t (B, X, R*px) with px = {px}, "
                         f"got {tuple(h1t.shape)}")
    b, x, r = h1t.shape[0], h1t.shape[1], h1t.shape[2] // px
    if tuple(shifts_y.shape) != (b, x):
        raise ValueError(f"shear_xy: want shifts_y {(b, x)}, got "
                         f"{tuple(shifts_y.shape)}")
    if tuple(shifts_x.shape) != (b, out_w):
        raise ValueError(f"shear_xy: want shifts_x {(b, out_w)}, got "
                         f"{tuple(shifts_x.shape)}")
    if min(x, r) < out_w + 2:
        raise ValueError(f"shear_xy: X = {x} and R = {r} must be >= out_w "
                         f"+ 2 = {out_w + 2}")
    return b, x, r


def shear_xy_plain(h1t: torch.Tensor, shifts_y: torch.Tensor,
                   shifts_x: torch.Tensor, out_w: int,
                   px: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the fused K5: the warp's y-shear (pass 2)
    on h1t (B, X, R*px) with shifts_y (B, X), a transpose of its output
    h2 (B, X, out_w*px) rounded to h1t's dtype, and the x-shear (pass 3)
    with shifts_x (B, out_w). Returns (B, out_w, out_w*px)."""
    b, x, _ = _check_xy(h1t, shifts_y, shifts_x, out_w, px)
    h2 = shear_x_plain(h1t, shifts_y, out_w, px)
    h2t = h2.reshape(b, x, out_w, px).transpose(1, 2).reshape(
        b, out_w, x * px)
    return shear_x_plain(h2t, shifts_x, out_w, px)


def shear_xy(h1t: torch.Tensor, shifts_y: torch.Tensor,
             shifts_x: torch.Tensor, out_w: int, px: int = 1) -> torch.Tensor:
    """`shear_xy_plain` in one launch on CUDA tensors: h2 never reaches
    device memory. h1t (B, X, R*px) float32 or bf16, contiguous; shifts_y
    (B, X) and shifts_x (B, out_w) float32, any values; px 1 or 3 on
    CUDA. Returns (B, out_w, out_w*px) in h1t's dtype."""
    if h1t.device.type == "cpu":
        return shear_xy_plain(h1t, shifts_y, shifts_x, out_w, px)
    if h1t.device.type != "cuda":
        raise ValueError(f"shear kernel: unsupported device {h1t.device}")
    b, x, r = _check_xy(h1t, shifts_y, shifts_x, out_w, px)
    if h1t.dtype not in _DTYPE_CODES:
        raise ValueError(f"shear kernel: img must be float32 or bfloat16, "
                         f"got {h1t.dtype}")
    if px not in (1, 3):
        raise ValueError(f"shear_xy kernel: px must be 1 or 3, got {px}")
    for t in (shifts_y, shifts_x):
        if t.dtype != torch.float32 or t.device != h1t.device:
            raise ValueError("shear kernel: shifts must be float32 on the "
                             "image's device")
    if not all(t.is_contiguous() for t in (h1t, shifts_y, shifts_x)):
        raise ValueError("shear kernel: inputs must be contiguous")
    out = torch.empty((b, out_w, out_w * px), dtype=h1t.dtype,
                      device=h1t.device)
    if out.numel() == 0:
        return out
    _build.launch(_build.load("warp").yolox_shear_xy, h1t.device,
                  "shear_xy kernel", h1t.data_ptr(), shifts_y.data_ptr(),
                  shifts_x.data_ptr(), out.data_ptr(), b, x, r, out_w, px,
                  _DTYPE_CODES[h1t.dtype])
    shear_xy.launches += 1
    return out


shear_xy.launches = 0
