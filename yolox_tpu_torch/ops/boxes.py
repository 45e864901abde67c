"""Box format conversions and pairwise IoU (torch), as in the JAX package's
`yolox_tpu/ops/boxes.py`. Pure functions over leading batch dims;
`matrix_iou` works on numpy arrays (data augmentation's)."""

from __future__ import annotations

import numpy as np
import torch


def cxcywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def xyxy2cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1 + w * 0.5, y1 + h * 0.5, w, h], dim=-1)


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 0.0) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes a (..., N, 4) x b (..., M, 4) -> (..., N, M).

    torchvision-compatible (no +1 on extents); the intersection counts only
    where tl < br strictly. Every operation is one float op in the JAX
    package's order, so results are bit-equal to it and to the NMS kernel.
    """
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    en = (tl < br).all(dim=-1).to(a.dtype)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * en
    return area_i / (area_a[..., :, None] + area_b[..., None, :] - area_i + eps)


def bboxes_iou(bboxes_a: torch.Tensor, bboxes_b: torch.Tensor,
               xyxy: bool = True) -> torch.Tensor:
    """Pairwise IoU of xyxy, or with `xyxy=False` (cx, cy, w, h), boxes."""
    if xyxy:
        return pairwise_iou_xyxy(bboxes_a, bboxes_b)
    return pairwise_iou_xyxy(cxcywh2xyxy(bboxes_a), cxcywh2xyxy(bboxes_b))


def filter_box(output: torch.Tensor, scale_range) -> torch.Tensor:
    """The rows of `output` (N, >= 4 columns, xyxy first) whose box area
    lies strictly between min_scale^2 and max_scale^2."""
    min_scale, max_scale = scale_range
    w = output[:, 2] - output[:, 0]
    h = output[:, 3] - output[:, 1]
    keep = (w * h > min_scale * min_scale) & (w * h < max_scale * max_scale)
    return output[keep]


def matrix_iou(a: np.ndarray, b: np.ndarray,
               eps: float = 1e-12) -> np.ndarray:
    """Pairwise IoU of numpy xyxy boxes a (N, 4) x b (M, 4) -> (N, M)."""
    lt = np.maximum(a[:, np.newaxis, :2], b[:, :2])
    rb = np.minimum(a[:, np.newaxis, 2:], b[:, 2:])
    area_i = np.prod(rb - lt, axis=2) * (lt < rb).all(axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return area_i / (area_a[:, np.newaxis] + area_b - area_i + eps)
