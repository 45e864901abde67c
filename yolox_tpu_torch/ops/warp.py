"""The affine warp engine of the device augmentation.

The PyTorch counterpart of the JAX package's `yolox_tpu/ops/pallas_warp.py`,
batched over B where the JAX code uses `vmap`. The mosaic + affine warp

  output(x) = canvas(Minv x + t),  Minv = D · L · U   (scale leftmost)

runs as three passes (`data/device_augment.py` is the consumer):

  1. **scale pass**: h1 = resample of the virtual mosaic canvas at scale
     and translate D, t, computed canvas-free as two batched matrix
     products of banded bilinear weights with the 4 tiles, with the 114
     border entering through the weight deficit `114 * (1 - coverage)`;
     the 2x canvas never exists;
  2. **y-shear**: h2[r, s] = h1[r + cL*(s - m), s], a per-column vertical
     shift run as the x-shear on the transpose;
  3. **x-shear**: out[i, j] = h2[i, j + uU*i + m], a per-row horizontal
     fractional shift.

Passes 2 and 3 are the kernel K5, fused into one launch on CUDA tensors
(`ops/shear_kernel.py::shear_xy`; `shear_xy_plain`, the two single-pass
shears and a transpose, on CPU tensors). The three passes differ
from single-pass bilinear (`data/device_augment.py::mosaic_warp`) only in
interpolation order; the decomposition needs |rotation + shear| < 90°,
which the augmentation ranges guarantee.

Compute dtype: on CUDA tensors the interpolation products and the buffers
between passes are bfloat16 (pixel values 0..255 are exact in bf16, the
bilinear weights round to ~2^-9 relative; the products accumulate in
float32), on CPU tensors float32, as the JAX package does on the TPU and
the CPU. The device decides (`compute_dtype_for`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from yolox_tpu_torch.ops.shear_kernel import (
    shear_x,
    shear_x_plain,
    shear_xy,
    shear_xy_plain,
)

PAD = 114.0

__all__ = ["PAD", "affine_inverse_2x3", "compute_dtype_for", "default_margin",
           "ldu_decompose", "margin_for", "margin_for_slope", "mixup_resample",
           "mosaic_affine_warp", "scale_resample_tiles", "shear_x",
           "shear_x_plain", "shear_xy", "shear_xy_plain"]


def margin_for_slope(s: int, slope: float) -> int:
    """Shear slack for a |slope| bound: the passes need
    |slope| * (S + margin) <= margin, i.e. margin >= slope*S/(1-slope),
    rounded up to a multiple of 8, at least 128."""
    if slope >= 0.85:
        raise ValueError(
            f"affine slope bound {slope:.2f} too large for the decomposed "
            "warp (combined rotation+shear must stay well below 45 deg)")
    need = slope * s / (1.0 - slope)
    return max(128, int(math.ceil(need / 8.0)) * 8)


def margin_for(s: int, degrees: float, shear: float) -> int:
    """Margin for the augmentation ranges: the decomposed slopes |cl|, |uu|
    are bounded by tan(degrees + 2*shear), floored at slope 0.22."""
    slope = math.tan(math.radians(abs(degrees) + 2.0 * abs(shear)))
    return margin_for_slope(s, max(slope, 0.22))


def default_margin(s: int) -> int:
    """Slope 0.22 (~12.5 deg of rotation + shear): 640 px -> 192."""
    return margin_for_slope(s, 0.22)


def compute_dtype_for(device: torch.device) -> torch.dtype:
    """The interpolation products' dtype: bf16 on CUDA, float32 elsewhere."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def ldu_decompose(minv: torch.Tensor):
    """Minv = diag(p, q) @ [[1, 0], [cl, 1]] @ [[1, uu], [0, 1]] for
    minv (..., 2, 2); returns p, q, cl, uu, each (...). Valid while
    minv[..., 0, 0] != 0 (rotations far from 90°)."""
    a, b = minv[..., 0, 0], minv[..., 0, 1]
    c, d = minv[..., 1, 0], minv[..., 1, 1]
    uu = b / a
    q = d - c * uu
    cl = c / q
    return a, q, cl, uu


def affine_inverse_2x3(m: torch.Tensor):
    """(minv (..., 2, 2), tinv (..., 2)) of the affine maps m (..., 2, 3)."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    minv = torch.stack([torch.stack([ia, ib], -1),
                        torch.stack([ic, id_], -1)], -2)
    return minv, torch.stack([-(ia * tx + ib * ty), -(ic * tx + id_ * ty)],
                             -1)


# ---------------------------------------------------------------------------
# pass 1: canvas-free separable resample
# ---------------------------------------------------------------------------

def _hat(centers: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear weights (..., R, Y): max(0, 1 - |center_r - coord_y|)."""
    return torch.clamp(1.0 - (centers[..., :, None]
                              - coords[..., None, :]).abs(), min=0.0)


def _per_sample(v, device) -> torch.Tensor:
    """A float or (B,) value as a (B or 1,) float32 tensor."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)


def scale_resample_tiles(tiles, tile_hw, offsets, xs, ys, canvas_hw,
                         border=PAD, zero_outside_canvas=False,
                         transposed_out=False, compute_dtype=torch.float32,
                         out_dtype=torch.float32):
    """h1[b, r, s, c] = canvas_b(xs[b, s], ys[b, r]) for a virtual canvas of
    size canvas_hw holding `tiles` pasted at integer `offsets`,
    border-filled with `border` (cv2 BORDER_CONSTANT both outside the tiles
    and outside the canvas; with zero_outside_canvas, reads outside the
    canvas give 0 instead, the MixUp zero-pad).

    tiles (B, N, T, T, 3) uint8/float; tile_hw (B, N, 2) true sizes;
    offsets (B, N, 2) [ox, oy] (integer-valued); xs (B, W), ys (B, R)
    canvas coordinates; canvas_hw (ch, cw), each a float or a (B,) tensor.
    Returns (B, R, W, 3), or (B, W, R, 3) with transposed_out, in
    out_dtype.

    The products take compute_dtype inputs and accumulate in float32; the
    first rounds its output to compute_dtype, the second to out_dtype (the
    JAX package's preferred_element_type=float32 and casts).
    """
    b, n, t = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    dev = tiles.device
    ch, cw = (_per_sample(v, dev) for v in canvas_hw)
    idx = torch.arange(t, dtype=torch.float32, device=dev)
    ycv = offsets[..., 1:2].float() + idx               # (B, N, T) canvas y
    xcv = offsets[..., 0:1].float() + idx
    in_y = (idx < tile_hw[..., 0:1]) & (ycv >= 0) & (ycv < ch[:, None, None])
    in_x = (idx < tile_hw[..., 1:2]) & (xcv >= 0) & (xcv < cw[:, None, None])
    ay = _hat(ys[:, None, :], ycv) * in_y[:, :, None, :]  # (B, N, R, T)
    ax = _hat(xs[:, None, :], xcv) * in_x[:, :, None, :]  # (B, N, W, T)
    r_len, w_len = ay.shape[2], ax.shape[2]

    # tmp[b, n, (x, c), r] = sum_y tiles[b, n, y, (x, c)] ay[b, n, r, y]:
    # one batched product on transposed views, no copy of either operand
    cdt = compute_dtype
    tmp = torch.matmul(tiles.to(cdt).reshape(b, n, t, t * 3).transpose(2, 3),
                       ay.to(cdt).transpose(2, 3))    # (B, N, T*3, R)
    # h[b, s, (c, r)] = sum_(n, x) ax[b, n, s, x] tmp[b, n, x, c, r]: the
    # tile axis concatenated along the contraction, so the sum over tiles
    # happens inside the product
    pdt = torch.float32 if out_dtype == torch.float32 else cdt
    axc = ax.to(cdt).transpose(1, 2).reshape(b, w_len, n * t)
    h = torch.matmul(axc.to(pdt), tmp.reshape(b, n * t, 3 * r_len).to(pdt))
    h = h.reshape(b, w_len, 3, r_len)
    h1 = h.permute(0, 1, 3, 2) if transposed_out else h.permute(0, 3, 1, 2)

    # coverage: sum over tiles of outer(ay_n . 1, ax_n . 1), float32 (the
    # deficit multiplies the border value)
    cov = torch.clamp(torch.matmul(ay.sum(3).transpose(1, 2), ax.sum(3)),
                      0.0, 1.0)                       # (B, R, W)
    if zero_outside_canvas:
        covy = torch.clamp(torch.minimum(ys + 1.0, ch[:, None] - ys), 0.0, 1.0)
        covx = torch.clamp(torch.minimum(xs + 1.0, cw[:, None] - xs), 0.0, 1.0)
        bterm = border * torch.clamp(covy[:, :, None] * covx[:, None, :] - cov,
                                     min=0.0)
    else:
        bterm = border * (1.0 - cov)
    if transposed_out:
        bterm = bterm.transpose(1, 2)
    return (h1.to(out_dtype) + bterm.to(out_dtype)[..., None]).contiguous()


# ---------------------------------------------------------------------------
# full warp: mosaic tiles + affine -> output
# ---------------------------------------------------------------------------

def _mosaic_offsets(tile_hw, xc, yc):
    """(B, 4, 2) [ox, oy] paste origins of the 4 tiles around the mosaic
    centre (TL, TR, BL, BR)."""
    h, w = tile_hw[..., 0], tile_hw[..., 1]
    xc, yc = xc[:, None], yc[:, None]
    zero = torch.zeros_like(w[:, :1])
    ox = torch.cat([xc - w[:, 0:1], xc + zero, xc - w[:, 2:3], xc + zero], 1)
    oy = torch.cat([yc - h[:, 0:1], yc - h[:, 1:2], yc + zero, yc + zero], 1)
    return torch.stack([ox, oy], -1)


def mosaic_affine_warp(tiles, tile_hw, m, xc, yc, out_size: Tuple[int, int],
                       margin: int = None, out_dtype=torch.float32):
    """Batched mosaic + affine warp in three passes.

    tiles (B, 4, T, T, 3) uint8; tile_hw (B, 4, 2); m (B, 2, 3) affine
    (canvas -> output, cv2 convention); xc, yc (B,) mosaic centres.
    Returns (B, S, S, 3) `out_dtype`; out_size must be square.

    The shear slopes must satisfy |slope| * (S + margin) <= margin;
    `default_margin` covers rotation + shear up to ~12.5 deg. Beyond that,
    shifts clamp at the working grid's edge.
    """
    s = out_size[0]
    if out_size[0] != out_size[1]:
        raise ValueError(f"mosaic output must be square, got {out_size}")
    if margin is None:
        margin = default_margin(s)
    # working grid, rounded up to 64 rows
    wr = ((s + 2 * margin + 63) // 64) * 64
    b, dev = tiles.shape[0], tiles.device
    cdt = compute_dtype_for(dev)

    minv, tinv = affine_inverse_2x3(m.float())
    p, q, cl, uu = ldu_decompose(minv)
    grid = torch.arange(wr, dtype=torch.float32, device=dev) - margin
    xs = p[:, None] * grid + tinv[:, 0:1]
    ys = q[:, None] * grid + tinv[:, 1:2]
    hw = tile_hw.float()
    offs = _mosaic_offsets(hw, xc.float(), yc.float())

    # pass 1, emitted x-major (B, WR_x, WR_y, 3) for pass 2
    h1t = scale_resample_tiles(tiles, hw, offs, xs, ys, (2 * s, 2 * s),
                               transposed_out=True, compute_dtype=cdt,
                               out_dtype=cdt).reshape(b, wr, wr * 3)
    # pass 2 (y-shear): h2[r, s'] = h1[r + cl*(s' - margin), s'], run as an
    # x-shear over the channel-interleaved transposed rows; pass 3
    # (x-shear): out[i, j] = h2[i, j + uu*i + margin]. One kernel on the
    # card (h2 stays on chip), the two shears and a transpose on the CPU.
    col = torch.arange(wr, dtype=torch.float32, device=dev)
    shifts_y = cl[:, None] * (col - margin) + margin            # (B, WR)
    row = torch.arange(s, dtype=torch.float32, device=dev)
    shifts_x = uu[:, None] * row + margin                       # (B, S)
    out = shear_xy(h1t, shifts_y.contiguous(), shifts_x.contiguous(), s,
                   px=3)
    return out.reshape(b, s, s, 3).to(out_dtype)


def mixup_resample(p_tile, p_hw, r, do_flip, x_off, y_off,
                   out_size: Tuple[int, int], out_flip=False,
                   out_dtype=torch.float32):
    """MixUp partner resample (reference geometry), batched: letterbox to
    the input size, scale the whole canvas by the jitter factor (total
    content scale `r`), optional h-flip, zero-pad, crop at (x_off, y_off).
    One separable pass.

    p_tile (B, T, T, 3); p_hw (B, 2); r, x_off, y_off (B,); do_flip (B,)
    bool; out_flip a bool or (B,) bool that also mirrors the output x axis
    (the final TrainTransform flip folded into the sample coordinates).
    Returns (B, S, S, 3) `out_dtype`."""
    oh, ow = out_size
    dev = p_tile.device
    p_hw = p_hw.float()
    r0 = torch.minimum(oh / p_hw[:, 0], ow / p_hw[:, 1])
    jf = r / r0
    hj, wj = oh * jf, ow * jf
    rr = r[:, None]
    ys = (torch.arange(oh, dtype=torch.float32, device=dev)
          + y_off[:, None]) / rr
    j = torch.arange(ow, dtype=torch.float32, device=dev)[None]
    out_flip = torch.as_tensor(out_flip, device=dev).reshape(-1, 1)
    j = torch.where(out_flip, (ow - 1.0) - j, j)
    xs_canvas = j + x_off[:, None]
    # un-flip in jittered-canvas coordinates (the flip reads wj-1-x), then
    # scale down to tile coordinates
    xs = torch.where(do_flip[:, None], (wj[:, None] - 1.0) - xs_canvas,
                     xs_canvas) / rr
    return scale_resample_tiles(
        p_tile[:, None], p_hw[:, None],
        torch.zeros((p_tile.shape[0], 1, 2), device=dev), xs, ys, (hj, wj),
        border=PAD, zero_outside_canvas=True,
        compute_dtype=compute_dtype_for(dev), out_dtype=out_dtype)
