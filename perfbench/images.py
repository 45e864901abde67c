"""Seeded images, made on the device (and handed to the host where the
traffic feeds the program from the host).

A frame is a smooth background around the mid grey of the letterbox
padding (a coarse normal field, bilinearly upsampled by 64, plus fine
noise) with a few painted rectangles of flat colour and texture, the
objects: the anchors on an object see alike features that differ from the
background's, so a calibrated head scores them as a trained one scores
the anchors around an object. Each traffic file lists the frame shapes it
uses with their counts; a seed changes the pixels and the order, never
the set of shapes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.weights import seed_generator


def _paint(x, g, objects: int):
    """Paint `objects` rectangles on each (n, 3, h, w) frame of `x`: a flat
    colour at a fixed distance (80 levels) from the grey in a direction
    drawn per object, plus the background's texture at half strength;
    sides log-uniform in [h / 24, h / 8], at a uniform place (clipped at
    the frame's edge)."""
    n, _, h, w = x.shape
    dev = x.device
    u = torch.rand((n, objects, 4), generator=g, device=dev)
    direction = torch.randn((n, objects, 3), generator=g, device=dev)
    side = min(h, w) / 24 * torch.exp(u[..., 0:2] * float(np.log(3.0)))
    y0, x0 = u[..., 2] * h - side[..., 0] / 2, u[..., 3] * w - side[..., 1] / 2
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, None, :]
    inside = ((ys >= y0[..., None, None]) & (ys < (y0 + side[..., 0])[..., None, None])
              & (xs >= x0[..., None, None])
              & (xs < (x0 + side[..., 1])[..., None, None]))   # (n, k, h, w)
    colour = 114.0 + 80.0 * direction / direction.norm(dim=-1,
                                                       keepdim=True)
    for k in range(objects):
        m = inside[:, k:k + 1]
        x = torch.where(m, colour[:, k, :, None, None] + (x - 114.0) * 0.5,
                        x)
    return x


OBJECTS = 6  # painted rectangles a frame


def frames(shapes, seed: int, device) -> list:
    """One HWC uint8 numpy frame per (h, w) in `shapes`, in that order."""
    g = seed_generator(seed, device)
    out = []
    for h, w in shapes:
        out.append(_frame_batch(1, h, w, g, device)[0]
                   .round().to(torch.uint8))
    return [f.cpu().numpy() for f in out]


def _frame_batch(n, h, w, g, device):
    """(n, h, w, 3) float frames: a smooth background around the letterbox
    grey, with OBJECTS painted rectangles each."""
    coarse = torch.randn((n, 3, -(-h // 64), -(-w // 64)), generator=g,
                         device=device) * 20.0
    x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=False)
    x = x + torch.randn((n, 3, h, w), generator=g, device=device) * 6.0
    x = _paint(x + 114.0, g, OBJECTS)
    return x.clamp(0, 255).permute(0, 2, 3, 1).contiguous()


def letterboxed(frame: np.ndarray, size) -> np.ndarray:
    """A frame no larger than `size` pasted top-left on the 114 canvas, as
    the letterbox leaves a frame whose long side is already the target."""
    canvas = np.full((size[0], size[1], 3), 114, np.uint8)
    canvas[:frame.shape[0], :frame.shape[1]] = frame
    return canvas


def shape_list(spec) -> list:
    """[[h, w, count], ...] -> [(h, w)] * count, in order."""
    return [(h, w) for h, w, n in spec for _ in range(n)]


def permutation(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(int(seed)).permutation(n)
