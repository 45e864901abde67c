"""The cv2 image operations of the host data path, with numpy versions
for hosts that have no cv2.

The JAX package's host path calls `cv2.resize`, `cv2.warpAffine`,
`cv2.cvtColor` (BGR <-> HSV) and `cv2.getRotationMatrix2D`. A host
without cv2 could not letterbox a frame whose ratio is not 1, nor run a
Mosaic. Each function here calls cv2 when it imported (decided once, when
this module is imported) and otherwise runs its numpy version, which
repeats, for uint8 images, the arithmetic of opencv-python 5.0.0.93 (the
x86-64 wheel, CPU features up to AVX512-SKX, whose HSV -> BGR loop takes
32 pixels a pass):

- `resize_linear`: INTER_LINEAR with 11-bit fixed-point coefficients, a
  horizontal pass into int32 and a vertical pass that shifts each product
  by 16 and the sum by 2 with rounding; an exact 2x downscale in both axes
  is cv2's 2x2 area average, as in cv2.
- `warp_affine`: INTER_LINEAR with BORDER_CONSTANT as cv2 5 computes it:
  the inverse map in float32 (row offsets M1*y + M2 rounded once, columns
  by a fused multiply-add), taps outside the image take the border value,
  a horizontal then vertical lerp by fused multiply-adds, rounded to
  nearest even. With `cv2_major=4` it is cv2 4.x's route instead: the
  map in 1/1024 px (AB_BITS 10) cut to 1/32 px (INTER_BITS 5), 15-bit
  bilinear weights. The numpy route of a host without cv2 takes cv2 5's.
- `bgr_to_hsv`: cv2's integer division tables (exact);
  `hsv_to_bgr`: cv2's float formula, truncated in its vector loop over
  blocks of 32 pixels of a row and rounded in its scalar loop over the
  last `width % 32` pixels (`_HSV_BLOCK`; a cv2 built for other vector
  widths draws that line elsewhere, and differs there by one level).
- `rotation_matrix_2d`: the closed form of `getRotationMatrix2D` about
  the origin (always used; equal to cv2's to the bit).

Another cv2 build may round differently: `chip_smoke.cv2_compat_vs_host`
holds the numpy versions against a host's own cv2 (bit-equal to
opencv-python 4.13.0 with the warp's cv2 4.x route). `route()` says which
of the two runs on this host. The numpy versions are public (`*_numpy`)
so that tests can hold them to cv2.
"""

from __future__ import annotations

import math
import sys
from typing import Tuple

import numpy as np

__all__ = ["route", "resize_linear", "warp_affine", "bgr_to_hsv",
           "hsv_to_bgr", "rotation_matrix_2d", "resize_linear_numpy",
           "warp_affine_numpy", "bgr_to_hsv_numpy", "hsv_to_bgr_numpy"]

_COEF_SCALE = 2048          # INTER_RESIZE_COEF_SCALE, 11 bits
_F32 = np.float32


try:        # decided once, at import: no import search on every call
    import cv2 as _CV2
except ImportError:
    _CV2 = None


def _cv2():
    """cv2 when it imported, unless `sys.modules["cv2"]` has since been
    set to None (the standard way to hide a module, which tests use)."""
    return None if sys.modules.get("cv2", _CV2) is None else _CV2


def route() -> str:
    """'cv2' when cv2 imports on this host, else 'numpy'."""
    return "cv2" if _cv2() is not None else "numpy"


# ------------------------------------------------------------------ resize

def _linear_taps(dst: int, src: int, clamp: bool):
    """Source indices and 11-bit weights of INTER_LINEAR along one axis.
    The horizontal axis clamps the position at the edges (weights 1, 0);
    the vertical axis keeps the weights and clips the row indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low], s[low] = 0, 0
        f[high], s[high] = 0, src - 1
    w0 = np.rint((_F32(1) - f) * _F32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * _F32(_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_numpy(img: np.ndarray, size_wh: Tuple[int, int]):
    """cv2.resize(img, size_wh, interpolation=INTER_LINEAR) for uint8 HW or
    HWC images, in numpy."""
    w, h = int(size_wh[0]), int(size_wh[1])
    src_h, src_w = img.shape[:2]
    if (w, h) == (src_w, src_h):
        return img.copy()
    s = img.astype(np.int32)
    if src_w == 2 * w and src_h == 2 * h:   # cv2 takes its 2x2 area path
        out = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
               + s[1::2, 1::2] + 2) >> 2
        return out.astype(np.uint8)
    tail = (1,) * (img.ndim - 2)
    x0, x1, a0, a1 = _linear_taps(w, src_w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(h, src_h, clamp=False)
    rows = (s[:, x0] * a0.reshape((1, -1) + tail)
            + s[:, x1] * a1.reshape((1, -1) + tail))
    b0, b1 = b0.reshape((-1, 1) + tail), b1.reshape((-1, 1) + tail)
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
           + 2) >> 2
    return out.astype(np.uint8)


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """INTER_LINEAR resize of a uint8 image to (w, h): cv2 when present,
    else `resize_linear_numpy`."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, tuple(size_wh), interpolation=cv2.INTER_LINEAR)
    return resize_linear_numpy(img, size_wh)


# ------------------------------------------------------------------ affine

def _fma32(a, b, c):
    """float32 a * b + c with one rounding (the products these inputs form
    are exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _invert_affine(m) -> list:
    """cv2.warpAffine's inverse of a forward 2x3 map, in float64 and in
    its order of operations."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


# cv2 4.x's fixed-point warp: the map in 1/1024 px (AB_BITS), cut to
# 1/32 px (INTER_BITS), 15-bit bilinear weights (INTER_REMAP_COEF_BITS)
_AB_BITS, _INTER_BITS, _REMAP_BITS = 10, 5, 15


def _warp_affine_fixed(img, inv, out_w, out_h, border_value):
    """cv2 4.x's INTER_LINEAR warpAffine of a uint8 HWC image, given the
    inverse map `inv` (float64, 6 values)."""
    ab, tab = 1 << _AB_BITS, 1 << _INTER_BITS
    xs = np.arange(out_w, dtype=np.float64)
    ys = np.arange(out_h, dtype=np.float64)
    adelta = np.rint(inv[0] * xs * ab).astype(np.int64)
    bdelta = np.rint(inv[3] * xs * ab).astype(np.int64)
    round_delta = ab // tab // 2
    x0 = np.rint((inv[1] * ys + inv[2]) * ab).astype(np.int64) + round_delta
    y0 = np.rint((inv[4] * ys + inv[5]) * ab).astype(np.int64) + round_delta
    shift = _AB_BITS - _INTER_BITS
    fx_ = (x0[:, None] + adelta[None, :]) >> shift
    fy_ = (y0[:, None] + bdelta[None, :]) >> shift
    ix, iy = fx_ >> _INTER_BITS, fy_ >> _INTER_BITS
    fx, fy = (fx_ & (tab - 1))[..., None], (fy_ & (tab - 1))[..., None]
    h, w = img.shape[:2]

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, border_value).astype(np.int64)

    unit = (1 << _REMAP_BITS) // (tab * tab)
    acc = (tap(0, 0) * ((tab - fy) * (tab - fx)) + tap(0, 1) * ((tab - fy) * fx)
           + tap(1, 0) * (fy * (tab - fx)) + tap(1, 1) * (fy * fx)) * unit
    out = (acc + (1 << (_REMAP_BITS - 1))) >> _REMAP_BITS
    return np.clip(out, 0, 255).astype(np.uint8)


def warp_affine_numpy(img: np.ndarray, m, dsize: Tuple[int, int],
                      border_value: int = 114,
                      cv2_major: int = 5) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize, borderValue=(v, v, v)) for a uint8
    HWC image (INTER_LINEAR, BORDER_CONSTANT), in numpy, as cv2 5 computes
    it (float map and lerps) or with `cv2_major=4` as cv2 4.x does (the
    map quantised to 1/32 px, 15-bit weights)."""
    out_w, out_h = int(dsize[0]), int(dsize[1])
    if cv2_major == 4:
        return _warp_affine_fixed(img, _invert_affine(m), out_w, out_h,
                                  border_value)
    inv = np.asarray(_invert_affine(m), np.float64).astype(_F32)
    xs = np.arange(out_w, dtype=_F32)[None, :]
    ys = np.arange(out_h, dtype=_F32)[:, None]
    row_x = (inv[1] * ys).astype(_F32) + inv[2]
    row_y = (inv[4] * ys).astype(_F32) + inv[5]
    src_x = _fma32(inv[0], xs, row_x)
    src_y = _fma32(inv[3], xs, row_y)
    ix, iy = np.floor(src_x), np.floor(src_y)
    fx = (src_x - ix)[..., None]
    fy = (src_y - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = img.shape[:2]

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, border_value).astype(_F32)

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma32(fx, v01 - v00, v00)
    bottom = _fma32(fx, v11 - v10, v10)
    out = _fma32(fy, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, m, dsize: Tuple[int, int],
                border_value: int = 114) -> np.ndarray:
    """INTER_LINEAR affine warp of a uint8 HWC image with a constant
    border: cv2 when present, else `warp_affine_numpy`."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.warpAffine(img, np.asarray(m, np.float64), tuple(dsize),
                              borderValue=(border_value,) * 3)
    return warp_affine_numpy(img, m, dsize, border_value)


# --------------------------------------------------------------------- HSV

def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << 12) / i)
    hdiv[1:] = np.rint((180 << 12) / (6.0 * i))
    return sdiv, hdiv


def bgr_to_hsv_numpy(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) for uint8 (H on 0..179), in numpy."""
    sdiv, hdiv = _hsv_tables()
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * sdiv[v] + 2048) >> 12
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + 2048) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# pixels of a row in one pass of cv2's vectorised HSV -> BGR loop (4 x 8
# float lanes); the rest of the row takes its scalar loop
_HSV_BLOCK = 32
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                    [2, 1, 0]])


def hsv_to_bgr_numpy(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2BGR) for uint8 (H on 0..179), in numpy:
    s and v scaled by 1/255, the hue sector's three products with fused
    multiply-adds, times 255, truncated (rounded in each row's last
    `width % _HSV_BLOCK` pixels)."""
    one = _F32(1)
    h = img[..., 0].astype(_F32) * _F32(6.0 / 180)
    s = img[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = img[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    sector = np.trunc(h)
    frac = h - sector
    sector = (sector - np.trunc(sector * _F32(1.0 / 6.0)) * _F32(6))
    sector = sector.astype(np.int64)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, frac, one),
                    v * _fma32(-s, one - frac, one)], -1)
    out = np.take_along_axis(tab, _SECTOR[sector], -1) * _F32(255)
    res = np.trunc(out)
    tail = img.shape[-2] % _HSV_BLOCK
    if tail:
        res[..., -tail:, :] = np.rint(out[..., -tail:, :])
    return np.clip(res, 0, 255).astype(np.uint8)


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """BGR uint8 -> HSV uint8 (H on 0..179): cv2 when present, else numpy."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    return bgr_to_hsv_numpy(img)


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """HSV uint8 (H on 0..179) -> BGR uint8: cv2 when present, else numpy."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.cvtColor(img, cv2.COLOR_HSV2BGR)
    return hsv_to_bgr_numpy(img)


# ---------------------------------------------------------------- rotation

def rotation_matrix_2d(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center=(0, 0), angle, scale): the 2x3
    matrix [[a, b, 0], [-b, a, 0]] with a = scale cos, b = scale sin of
    the angle in degrees."""
    t = angle * (math.pi / 180)
    a, b = math.cos(t) * scale, math.sin(t) * scale
    return np.array([[a, b, 0.0], [-b, a, 0.0]])
