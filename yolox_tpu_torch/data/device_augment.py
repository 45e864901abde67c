"""On-device Mosaic/affine/MixUp/HSV/flip augmentation.

The PyTorch counterpart of the JAX package's
`yolox_tpu/data/device_augment.py`, batched over B where the JAX code uses
`vmap`. The host only decodes and pre-resizes images into tiles; all
geometry and photometric augmentation runs on the device. The warp runs through the three-pass engine in
`ops/warp.py` (two batched interpolation products and the shear kernel
K5); labels go through the same composed transform in closed form. A
gather-based single-pass warp (`mosaic_warp`, `warp_affine`) is kept as
the tests' oracle.

Semantics follow the reference formulas (`yolox/data/datasets/
mosaicdetection.py`): the same mosaic paste geometry, affine matrix, label
clipping and filtering. Sampling is split from the transform:
`sample_augment_draws` takes every random draw of a batch from an explicit
`torch.Generator`, `augment_with_draws` is deterministic given them, and
`device_augment_batch` runs both. A generator gives other numbers than a
JAX key, so the two packages' streams are the same distribution, not the
same samples; given the same draws, they compute the same batch. In
distribution the engine is held to JAX's engine and to the host pipeline
(`MosaicDetection` + `TrainTransform`) by
`tests/test_torch_augment_equivalence.py`, and on a card by
`chip_smoke.py` phase 17.

Input per sample: 4 mosaic tiles and 1 MixUp partner tile, each
pre-resized to fit (S, S) and zero-padded, their true (h, w), and padded
xyxy+cls labels; `TileDataset` serves them on the host.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from yolox_tpu_torch.data.cv2_compat import resize_linear
from yolox_tpu_torch.ops.warp import (
    PAD,
    margin_for,
    mixup_resample,
    mosaic_affine_warp,
)

Draws = Dict[str, torch.Tensor]


class TileDataset:
    """Host side of the device pipeline: serves raw tiles, no augmentation
    (the JAX package's `TileDataset`, `device_augment.py:42-115`).

    Each item is (tiles (5, T, T, 3) uint8, labels (5, L, 5) float32
    xyxy+cls, tile_hw (5, 2) float32, img_id): the sample's own image, 3
    mosaic partners and a MixUp partner (one with labels, as in the
    reference's retry loop), each pre-resized by the wrapped dataset's
    `pull_item` and zero-padded to (T, T). The partners are drawn from the
    sample's seed in the JAX package's order.
    """

    def __init__(self, dataset, tile_size: int, max_labels_per_tile: int = 60):
        self._dataset = dataset
        self.tile_size = int(tile_size)
        self.max_labels = int(max_labels_per_tile)
        self.enable_mosaic = True  # close_mosaic() compatibility
        self.input_dim = (self.tile_size, self.tile_size)

    def __len__(self):
        return len(self._dataset)

    def _pull(self, index):
        img, labels, _, img_id = self._dataset.pull_item(index)
        t = self.tile_size
        h, w = img.shape[0], img.shape[1]
        if h > t or w > t:  # pull_item pre-resizes to <= t; others may not
            r = min(t / h, t / w)
            img = resize_linear(img, (int(w * r), int(h * r)))
            labels = labels.copy()
            labels[:, :4] *= r
            h, w = img.shape[0], img.shape[1]
        tile = np.zeros((t, t, 3), np.uint8)
        tile[:h, :w] = img
        lab = np.zeros((self.max_labels, 5), np.float32)
        n = min(len(labels), self.max_labels)
        lab[:n] = labels[:n]
        return tile, lab, (h, w), img_id

    def __getitem__(self, index):
        if not isinstance(index, int):  # (mosaic_flag, idx[, seed]) tuples
            seed = index[2] if len(index) > 2 else None
            rng = np.random.default_rng(seed)
            index = index[1]
        else:
            rng = np.random.default_rng()
        n = len(self._dataset)
        indices = [index] + [int(rng.integers(0, n)) for _ in range(3)]
        # the MixUp partner must have labels (the reference's retry loop,
        # `mosaicdetection.py:137-140`)
        while True:
            mix_idx = int(rng.integers(0, n))
            if len(self._dataset.load_anno(mix_idx)) > 0:
                break
        indices.append(mix_idx)

        tiles = np.zeros((5, self.tile_size, self.tile_size, 3), np.uint8)
        labels = np.zeros((5, self.max_labels, 5), np.float32)
        hw = np.zeros((5, 2), np.float32)
        img_id = None
        for i, idx in enumerate(indices):
            tiles[i], labels[i], hw_i, iid = self._pull(idx)
            hw[i] = hw_i
            if i == 0:
                img_id = iid
        return tiles, labels, hw, img_id


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def affine_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of 2x3 affine maps m (..., 2, 3) (rows [a b tx; c d ty])."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack([torch.stack([ia, ib, itx], -1),
                        torch.stack([ic, id_, ity], -1)], -2)


def _uniform(generator: torch.Generator, b: int, lo=0.0, hi=1.0):
    u = torch.rand(b, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def random_affine_matrix(generator: torch.Generator, b: int,
                         target_size: Tuple[int, int], degrees=10.0,
                         translate=0.1, scales=(0.5, 1.5), shear=2.0):
    """B random maps of the reference affine construction
    (`data_augment.py:44-77`): rotation times scale, then shear mixed into
    the rows, then translation. Returns (m (B, 2, 3), scale (B,))."""
    th, tw = target_size
    angle = _uniform(generator, b, -degrees, degrees)
    scale = _uniform(generator, b, scales[0], scales[1])
    rad = angle * (math.pi / 180.0)
    cos, sin = torch.cos(rad) * scale, torch.sin(rad) * scale
    # cv2.getRotationMatrix2D(center=(0, 0), angle, scale)
    r0 = torch.stack([cos, sin], -1)
    r1 = torch.stack([-sin, cos], -1)
    sx = torch.tan(_uniform(generator, b, -shear, shear)
                   * (math.pi / 180.0))[:, None]
    sy = torch.tan(_uniform(generator, b, -shear, shear)
                   * (math.pi / 180.0))[:, None]
    tx = _uniform(generator, b, -translate, translate)
    ty = _uniform(generator, b, -translate, translate)
    m0 = r0 + sy * r1
    m1 = r1 + sx * r0
    m = torch.stack([torch.cat([m0, (tx * tw)[:, None]], -1),
                     torch.cat([m1, (ty * th)[:, None]], -1)], 1)
    return m, scale


def _bilinear_gather(img, xs, ys, pad_value=PAD):
    """Sample img (H, W, 3) at float coordinates; reads outside give
    pad_value (cv2.warpAffine BORDER_CONSTANT)."""
    h, w = img.shape[0], img.shape[1]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)].float()
        return torch.where(inside[..., None], v, pad_value)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def _out_grid(out_size, device):
    oh, ow = out_size
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32,
                                         device=device),
                            torch.arange(ow, dtype=torch.float32,
                                         device=device), indexing="ij")
    return ys, xs


def warp_affine(img, m, out_size: Tuple[int, int], pad_value=PAD):
    """cv2.warpAffine(img, m, dsize, borderValue=114) for img (H, W, 3) and
    m (2, 3): each output pixel samples the source at m^-1."""
    minv = affine_inverse(m.float())
    ys, xs = _out_grid(out_size, img.device)
    sx = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    sy = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    return _bilinear_gather(img, sx, sy, pad_value)


# ---------------------------------------------------------------------------
# mosaic: 4 tiles -> affine-warped (S, S) output, canvas never materialized
# ---------------------------------------------------------------------------

def _mosaic_geometry(tile_hw, xc, yc, s_h, s_w):
    """Per-tile paste rectangles in the 2x canvas and source offsets, the
    branch-free `get_mosaic_coordinate` (mosaicdetection.py:20).
    tile_hw (..., 4, 2) float (h, w); xc, yc (...). Returns paste
    (..., 4, 4) [x1, y1, x2, y2] and offset (..., 4, 2) [padw, padh]: canvas
    coordinate q samples tile t at u = q - offset_t."""
    h, w = tile_hw[..., 0], tile_hw[..., 1]
    xc = torch.as_tensor(xc, dtype=torch.float32, device=h.device)[..., None]
    yc = torch.as_tensor(yc, dtype=torch.float32, device=h.device)[..., None]
    zero = torch.zeros_like(xc)

    def col(i, v):
        return v[..., i:i + 1]

    x1 = torch.cat([(xc - col(0, w)).clamp(min=0), xc,
                    (xc - col(2, w)).clamp(min=0), xc], -1)
    y1 = torch.cat([(yc - col(0, h)).clamp(min=0),
                    (yc - col(1, h)).clamp(min=0), yc, yc], -1)
    x2 = torch.cat([xc, torch.clamp(xc + col(1, w), max=2 * s_w), xc,
                    torch.clamp(xc + col(3, w), max=2 * s_w)], -1)
    y2 = torch.cat([yc, yc, torch.clamp(yc + col(2, h), max=2 * s_h),
                    torch.clamp(yc + col(3, h), max=2 * s_h)], -1)
    # source crop origin (s_x1, s_y1) per reference; offset = l1 - s1
    s_x1 = torch.cat([col(0, w) - (col(0, x2) - col(0, x1)), zero,
                      col(2, w) - (col(2, x2) - col(2, x1)), zero], -1)
    s_y1 = torch.cat([col(0, h) - (col(0, y2) - col(0, y1)),
                      col(1, h) - (col(1, y2) - col(1, y1)), zero, zero], -1)
    paste = torch.stack([x1, y1, x2, y2], -1)
    offset = torch.stack([x1 - s_x1, y1 - s_y1], -1)
    return paste, offset


def mosaic_warp(tiles, tile_hw, m, xc, yc, out_size: Tuple[int, int]):
    """Single-pass mosaic paste + affine warp of one sample, by gathers:
    tiles (4, T, T, 3) pre-resized tiles zero-padded to T; tile_hw (4, 2)
    true (h, w); m (2, 3) canvas -> output. Returns (S, S, 3) float32."""
    oh, ow = out_size
    hw = tile_hw.float()
    paste, offset = _mosaic_geometry(hw, xc, yc, float(oh), float(ow))
    minv = affine_inverse(m.float())
    ys, xs = _out_grid(out_size, tiles.device)
    qx = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]   # canvas coords
    qy = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    # quadrant by mosaic centre: 0 TL, 1 TR, 2 BL, 3 BR
    t = (qx >= xc).long() + 2 * (qy >= yc).long()
    inside = ((qx >= paste[t, 0]) & (qx < paste[t, 2])
              & (qy >= paste[t, 1]) & (qy < paste[t, 3]))
    # clamp taps to the tile's true content (edge replication), so a
    # fractional tap never reads the padding or the next stacked tile
    ux = torch.minimum(torch.clamp(qx - offset[t, 0], min=0.0),
                       hw[t, 1] - 1.0)
    uy = torch.minimum(torch.clamp(qy - offset[t, 1], min=0.0),
                       hw[t, 0] - 1.0)
    big = tiles.reshape(-1, tiles.shape[2], tiles.shape[3])  # (4T, T, 3)
    sampled = _bilinear_gather(big, ux, uy + t.float() * tiles.shape[1])
    return torch.where(inside[..., None], sampled, PAD)


def transform_labels(labels, valid, scale_pad, m, out_size, min_size=1.0):
    """The mosaic label pipeline: per-tile scale + pad -> canvas clip ->
    affine of the corners (`apply_affine_to_bboxes`) -> output clip ->
    degenerate filter. labels (B, 4, L, 5) xyxy+cls; valid (B, 4, L) bool;
    scale_pad (B, 4, 3) [scale, padw, padh]; m (B, 2, 3). Returns
    (B, 4L, 5) and keep (B, 4L) bool."""
    oh, ow = out_size
    b = labels.shape[0]
    s = scale_pad[..., 0:1, None]
    pad = scale_pad[..., None, 1:3]
    xy1 = labels[..., 0:2] * s + pad
    xy2 = labels[..., 2:4] * s + pad
    boxes = torch.cat([xy1, xy2], -1).reshape(b, -1, 4)
    cls = labels[..., 4].reshape(b, -1)
    valid = valid.reshape(b, -1)
    boxes = torch.stack([
        boxes[..., 0].clamp(0, 2 * ow), boxes[..., 1].clamp(0, 2 * oh),
        boxes[..., 2].clamp(0, 2 * ow), boxes[..., 3].clamp(0, 2 * oh),
    ], -1)
    # affine of the 4 corners, then the min/max envelope
    cx = boxes[..., [0, 2, 0, 2]]
    cy = boxes[..., [1, 3, 3, 1]]

    def coef(i, j):
        return m[:, i, j, None, None]

    tx = coef(0, 0) * cx + coef(0, 1) * cy + coef(0, 2)
    ty = coef(1, 0) * cx + coef(1, 1) * cy + coef(1, 2)
    nb = torch.stack([
        tx.amin(-1).clamp(0, ow), ty.amin(-1).clamp(0, oh),
        tx.amax(-1).clamp(0, ow), ty.amax(-1).clamp(0, oh),
    ], -1)
    keep = valid & ((nb[..., 2] - nb[..., 0]) > min_size) \
        & ((nb[..., 3] - nb[..., 1]) > min_size)
    return torch.cat([nb, cls[..., None]], -1), keep


# ---------------------------------------------------------------------------
# photometric + flip + final label packing (TrainTransform analog)
# ---------------------------------------------------------------------------

def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """HSV jitter with `augment_hsv` semantics for img (B, H, W, 3) and
    gains (B, 3): hue shift mod 180 on the cv2 0..179 scale, saturation and
    value add + clip, each gain rounded half to even. The math runs in
    float32 (hue sextants are precision-sensitive); the output has the
    input's dtype."""
    in_dtype = img.dtype
    img = img.float()
    g = torch.round(gains.float())[:, None, None, :]
    r, gg, bb = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, gg), bb)
    minc = torch.minimum(torch.minimum(r, gg), bb)
    v = maxc
    d = maxc - minc
    s = torch.where(maxc > 0, d / maxc.clamp(min=1e-6) * 255.0, 0.0)
    dd = d.clamp(min=1e-6)
    h = torch.where(
        maxc == r, torch.remainder((gg - bb) / dd, 6.0),
        torch.where(maxc == gg, (bb - r) / dd + 2.0, (r - gg) / dd + 4.0))
    h = h * 30.0  # 0..180
    h = torch.remainder(h + g[..., 0], 180.0)
    s = torch.clamp(s + g[..., 1], 0, 255)
    v = torch.clamp(v + g[..., 2], 0, 255)
    # branch-free HSV -> RGB: f(n) = v - v*(s/255)*clip(min(k, 4-k), 0, 1),
    # k = (n + h/30) mod 6
    sv = v * (s / 255.0)

    def chan(n):
        k = torch.remainder(n + h / 30.0, 6.0)
        return v - sv * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], -1).to(in_dtype)


def _pack_labels(boxes_cls, keep, max_labels: int):
    """(B, max_labels, 5) rows (cls, cx, cy, w, h): kept rows first in
    their order (stable), zero rows after."""
    x1, y1, x2, y2 = (boxes_cls[..., i] for i in range(4))
    rows = torch.stack([boxes_cls[..., 4], (x1 + x2) / 2, (y1 + y2) / 2,
                        x2 - x1, y2 - y1], -1)
    rows = torch.where(keep[..., None], rows, 0.0)
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    rows = torch.gather(rows, -2, order[..., None].expand_as(rows))
    return _pad_rows(rows, max_labels)


def _pad_rows(rows, n):
    """rows (B, k, ...) cut or zero-padded to (B, n, ...)."""
    k = rows.shape[1]
    if k >= n:
        return rows[:, :n]
    pad = rows.new_zeros((rows.shape[0], n - k) + tuple(rows.shape[2:]))
    return torch.cat([rows, pad], 1)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _mixup_labels(p_lab, p_valid, r, do_flip, x_off, y_off, wj, hj,
                  out_size):
    """Partner label transform (reference `mosaicdetection.py:181-195`):
    scale by r, clip to the jittered canvas, flip within its width,
    subtract the crop offsets, clip to the target. p_lab (B, L, 5),
    p_valid (B, L), the rest (B,). Returns (B, L, 5), keep (B, L)."""
    oh, ow = out_size
    zero = torch.zeros((), device=p_lab.device)
    r, wj, hj = r[:, None], wj[:, None], hj[:, None]
    x1 = _clip(p_lab[..., 0] * r, zero, wj)
    y1 = _clip(p_lab[..., 1] * r, zero, hj)
    x2 = _clip(p_lab[..., 2] * r, zero, wj)
    y2 = _clip(p_lab[..., 3] * r, zero, hj)
    flip = do_flip[:, None]
    x1, x2 = torch.where(flip, wj - x2, x1), torch.where(flip, wj - x1, x2)
    xo, yo = x_off[:, None], y_off[:, None]
    nb = torch.stack([(x1 - xo).clamp(0, ow), (y1 - yo).clamp(0, oh),
                      (x2 - xo).clamp(0, ow), (y2 - yo).clamp(0, oh)], -1)
    keep = p_valid & ((nb[..., 2] - nb[..., 0]) > 1) \
        & ((nb[..., 3] - nb[..., 1]) > 1)
    return torch.cat([nb, p_lab[..., 4:5]], -1), keep


# ---------------------------------------------------------------------------
# the batch op
# ---------------------------------------------------------------------------

def sample_augment_draws(b: int, generator: torch.Generator,
                         out_size: Tuple[int, int] = (640, 640),
                         degrees: float = 10.0, translate: float = 0.1,
                         scales: Tuple[float, float] = (0.1, 2.0),
                         mixup_scale: Tuple[float, float] = (0.5, 1.5),
                         shear: float = 2.0, flip_prob: float = 0.5,
                         hsv_prob: float = 1.0, mosaic_prob: float = 1.0,
                         hgain: float = 5.0, sgain: float = 30.0,
                         vgain: float = 30.0) -> Draws:
    """Every random draw of a batch of B samples, on the generator's
    device: the mosaic centre (yc, xc, integer-valued), the affine m
    (B, 2, 3), the MixUp gate u_mix, jitter jf, flip mixflip and crop
    offsets (y_off, x_off), the flags do_mosaic, do_hsv, do_flip, and the
    HSV gains (B, 3)."""
    oh, ow = out_size
    d = {"yc": torch.floor(_uniform(generator, b, 0.5 * oh, 1.5 * oh)),
         "xc": torch.floor(_uniform(generator, b, 0.5 * ow, 1.5 * ow))}
    d["m"], _ = random_affine_matrix(generator, b, out_size, degrees,
                                     translate, scales, shear)
    d["u_mix"] = _uniform(generator, b)
    d["jf"] = _uniform(generator, b, mixup_scale[0], mixup_scale[1])
    d["mixflip"] = _uniform(generator, b) > 0.5
    d["y_off"] = torch.floor(_uniform(generator, b)
                             * torch.clamp(oh * d["jf"] - oh, min=0.0))
    d["x_off"] = torch.floor(_uniform(generator, b)
                             * torch.clamp(ow * d["jf"] - ow, min=0.0))
    d["do_mosaic"] = _uniform(generator, b) < mosaic_prob
    d["do_hsv"] = _uniform(generator, b) < hsv_prob
    d["do_flip"] = _uniform(generator, b) < flip_prob
    # augment_hsv: each gain uniform in [-gain, gain], kept with
    # probability 0.5
    gains = _uniform(generator, 3 * b, -1.0, 1.0).reshape(b, 3) \
        * torch.tensor([hgain, sgain, vgain], device=generator.device)
    d["hsv_gains"] = gains * (_uniform(generator, 3 * b).reshape(b, 3) < 0.5)
    return d


def augment_with_draws(tiles, tile_hw, labels, draws: Draws,
                       out_size: Tuple[int, int] = (640, 640),
                       max_labels: int = 120, degrees: float = 10.0,
                       shear: float = 2.0, enable_mixup: bool = True,
                       hsv_prob: float = 1.0, mosaic_prob: float = 1.0,
                       mixup_prob: float = 1.0,
                       image_dtype=torch.float32):
    """The train-time augmentation of a batch given its draws
    (`sample_augment_draws`), on the tiles' device; deterministic.

    tiles (B, 5, T, T, 3) uint8: 4 mosaic tiles and the MixUp partner;
    tile_hw (B, 5, 2) true (h, w); labels (B, 5, L, 5) xyxy+cls, zero rows
    padding. Returns images (B, S, S, 3) `image_dtype` on the 0-255 scale
    and labels (B, max_labels, 5) float32 rows (cls, cx, cy, w, h).

    Per sample, as MosaicDetection.__getitem__: if do_mosaic, mosaic of the
    4 tiles -> affine -> MixUp with the partner (if u_mix < mixup_prob and
    the mosaic has any annotation); else the plain letterboxed tile 0; then
    HSV (if do_hsv) -> flip (if do_flip) -> pack. `degrees` and `shear`
    size the warp's margin; mosaic_prob and hsv_prob >= 1.0 skip the plain
    path and the HSV select. `image_dtype` is also the dtype of the image
    buffers between stages; the HSV math runs in float32.
    """
    tiles = torch.as_tensor(tiles)
    dev = tiles.device
    tile_hw = torch.as_tensor(tile_hw, device=dev).float()
    labels = torch.as_tensor(labels, device=dev).float()
    d = {k: v.to(dev) for k, v in draws.items()}
    b = tiles.shape[0]
    oh, ow = out_size
    n_rows = 5 * labels.shape[2]

    # ---- labels (closed-form affine math) ----
    valid = labels.abs().sum(-1) > 0                         # (B, 5, L)
    _, offset = _mosaic_geometry(tile_hw[:, :4], d["xc"], d["yc"],
                                 float(oh), float(ow))
    sp = torch.cat([torch.ones((b, 4, 1), device=dev), offset], -1)
    boxes_m, keep_m = transform_labels(labels[:, :4], valid[:, :4], sp,
                                       d["m"], out_size)
    do_mix = torch.zeros(b, dtype=torch.bool, device=dev)
    if enable_mixup:
        # gate on ANY mosaic annotation, including boxes the size filter
        # drops: the reference's `len(mosaic_labels) != 0` counts them
        # (mosaicdetection.py:131-135)
        do_mix = (d["u_mix"] < mixup_prob) & valid[:, :4].flatten(1).any(1)
        r = torch.minimum(oh / tile_hw[:, 4, 0],
                          ow / tile_hw[:, 4, 1]) * d["jf"]
        boxes_p, keep_p = _mixup_labels(
            labels[:, 4], valid[:, 4], r, d["mixflip"], d["x_off"],
            d["y_off"], ow * d["jf"], oh * d["jf"], out_size)
        boxes_m = torch.cat([boxes_m, boxes_p], 1)
        keep_m = torch.cat([keep_m, keep_p & do_mix[:, None]], 1)
    boxes_m, keep_m = _pad_rows(boxes_m, n_rows), _pad_rows(keep_m, n_rows)

    # ---- images ----
    # The TrainTransform flip is folded into each image producer's sample
    # coordinates instead of a mirror pass at the end: it commutes with HSV
    # and the MixUp blend, and a bilinear warp of mirrored coordinates is
    # the mirror of the warp. Mosaic: x' = (ow - 1) - x composed into m.
    m = d["m"]
    m_flip = torch.cat([
        torch.stack([-m[:, 0, 0], -m[:, 0, 1], (ow - 1.0) - m[:, 0, 2]],
                    -1)[:, None],
        m[:, 1:2]], 1)
    m_used = torch.where(d["do_flip"][:, None, None], m_flip, m)
    img_m = mosaic_affine_warp(
        tiles[:, :4], tile_hw[:, :4], m_used, d["xc"], d["yc"], out_size,
        margin=margin_for(oh, degrees, shear), out_dtype=image_dtype)
    if enable_mixup:
        r0 = torch.minimum(oh / tile_hw[:, 4, 0], ow / tile_hw[:, 4, 1])
        part = mixup_resample(tiles[:, 4], tile_hw[:, 4], r0 * d["jf"],
                              d["mixflip"], d["x_off"], d["y_off"], out_size,
                              out_flip=d["do_flip"], out_dtype=image_dtype)
        img_m = torch.where(do_mix[:, None, None, None],
                            0.5 * img_m + 0.5 * part, img_m)

    if mosaic_prob >= 1.0:
        # every sample takes the mosaic path: no plain image is built
        img, boxes, keep = img_m, boxes_m, keep_m
    else:
        # plain path: letterboxed tile 0, mirrored per sample when flipped
        wn = labels[:, 0, :, 2] - labels[:, 0, :, 0]
        hn = labels[:, 0, :, 3] - labels[:, 0, :, 1]
        keep_n = _pad_rows(valid[:, 0] & (torch.minimum(wn, hn) > 1), n_rows)
        boxes_n = _pad_rows(labels[:, 0], n_rows)
        ys_g, xs_g = _out_grid(out_size, dev)
        flip = d["do_flip"][:, None, None]
        t0 = tiles[:, 0, :oh, :ow]
        src = torch.where(flip[..., None], t0.flip(2), t0)
        xs_eff = torch.where(flip, (ow - 1.0) - xs_g, xs_g)
        in0 = ((ys_g < tile_hw[:, 0, 0, None, None])
               & (xs_eff < tile_hw[:, 0, 1, None, None]))
        img_n = torch.where(in0[..., None], src.to(image_dtype),
                            torch.tensor(PAD, dtype=image_dtype, device=dev))
        mos = d["do_mosaic"]
        img = torch.where(mos[:, None, None, None], img_m, img_n)
        boxes = torch.where(mos[:, None, None], boxes_m, boxes_n)
        keep = torch.where(mos[:, None], keep_m, keep_n)

    # ---- TrainTransform tail: HSV -> pack (the flip is already in the
    # images; labels mirror here) ----
    hsv = hsv_jitter(img, d["hsv_gains"])
    img = hsv if hsv_prob >= 1.0 else torch.where(
        d["do_hsv"][:, None, None, None], hsv, img)
    fboxes = torch.stack([ow - boxes[..., 2], boxes[..., 1],
                          ow - boxes[..., 0], boxes[..., 3], boxes[..., 4]],
                         -1)
    boxes = torch.where(d["do_flip"][:, None, None], fboxes, boxes)
    return img, _pack_labels(boxes, keep, max_labels)


def device_augment_batch(
    tiles,          # (B, 5, T, T, 3) uint8: 4 mosaic tiles + MixUp partner
    tile_hw,        # (B, 5, 2) float32 true (h, w)
    labels,         # (B, 5, L, 5) float32 xyxy+cls, zero rows = padding
    generator: torch.Generator,
    out_size: Tuple[int, int] = (640, 640),
    max_labels: int = 120,
    degrees: float = 10.0,
    translate: float = 0.1,
    scales: Tuple[float, float] = (0.1, 2.0),
    mixup_scale: Tuple[float, float] = (0.5, 1.5),
    shear: float = 2.0,
    enable_mixup: bool = True,
    flip_prob: float = 0.5,
    hsv_prob: float = 1.0,
    mosaic_prob: float = 1.0,
    mixup_prob: float = 1.0,
    image_dtype=torch.float32,
):
    """Full train-time augmentation of a batch on the tiles' device:
    `sample_augment_draws` from `generator` (on its device), then
    `augment_with_draws`. Returns (images (B, S, S, 3) `image_dtype`,
    labels (B, max_labels, 5) float32 rows (cls, cx, cy, w, h))."""
    draws = sample_augment_draws(
        torch.as_tensor(tiles).shape[0], generator, out_size, degrees,
        translate, scales, mixup_scale, shear, flip_prob, hsv_prob,
        mosaic_prob)
    return augment_with_draws(
        tiles, tile_hw, labels, draws, out_size, max_labels, degrees, shear,
        enable_mixup, hsv_prob, mosaic_prob, mixup_prob, image_dtype)
