"""Fixed-shape detection postprocessing and NMS on the device, the PyTorch
counterpart of the JAX package's `yolox_tpu/ops/nms.py`:

  score-threshold mask -> top-K candidate selection -> decode
  -> class-aware greedy suppression (kernel K2, `ops/nms_kernel.py`)

Semantics match torchvision: candidates sorted by score descending (ties
-> lower original index first: both sorts are stable), suppression on
strict `iou > threshold`, class-aware NMS through the coordinate offset
max_coordinate + 1. Output is fixed-shape (B, max_det, 7) rows
(x1, y1, x2, y2, obj, cls_conf, cls_idx) + a validity mask, kept rows
first in score order. Nothing here waits for the device.
"""

from __future__ import annotations

import torch

from yolox_tpu_torch.models.head import exact_int_bound
from yolox_tpu_torch.ops.nms_kernel import nms_keep

NEG_INF_SCORE = -1e10


def _top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, ties toward the
    lower index (`lax.top_k`'s order; `torch.topk` does not promise it)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def nms_fixed(boxes, scores, iou_threshold: float, valid=None):
    """Class-agnostic NMS on score-sorted boxes (..., K, 4) / (..., K).
    Returns the keep mask."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    squeeze = boxes.dim() == 2
    if squeeze:
        boxes, valid = boxes[None], valid[None]
    keep = nms_keep(boxes.contiguous(), valid.contiguous(), iou_threshold)
    return keep[0] if squeeze else keep


def batched_nms_fixed(boxes, scores, classes, iou_threshold: float,
                      valid=None):
    """Class-aware NMS via the torchvision coordinate-offset trick, in f32
    outside the kernel: offset = class * (max valid coordinate + 1)."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.flatten(-2).amax(-1)
    offsets = classes.to(boxes.dtype) * (max_coord[..., None] + 1)
    return nms_fixed(boxes + offsets[..., None], scores, iou_threshold, valid)


def _compact(det, keep, k, max_det):
    """Kept rows to the front, preserving score order; pad to max_det."""
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True)[1]
    det = torch.gather(det, 1, order[..., None].expand_as(det))
    keep = torch.gather(keep, 1, order)
    if k < max_det:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_det - k))
        keep = torch.nn.functional.pad(keep, (0, max_det - k))
    return det, keep


def postprocess_device(prediction, num_classes: int, conf_thre: float = 0.7,
                       nms_thre: float = 0.45, class_agnostic: bool = False,
                       max_det: int = 1024):
    """Batched detection postprocess on the decoded model output
    (B, A, 5 + num_classes) rows (cx, cy, w, h, obj, cls...).
    Returns detections (B, max_det, 7) and valid (B, max_det) bool."""
    pred = prediction
    box_xyxy = torch.stack([pred[..., 0] - pred[..., 2] / 2,
                            pred[..., 1] - pred[..., 3] / 2,
                            pred[..., 0] + pred[..., 2] / 2,
                            pred[..., 1] + pred[..., 3] / 2], dim=-1)
    class_conf, class_pred = pred[..., 5:5 + num_classes].max(dim=-1)
    obj = pred[..., 4]
    score = obj * class_conf
    masked = torch.where(score >= conf_thre, score,
                         torch.full_like(score, NEG_INF_SCORE))

    k = min(max_det, pred.shape[1])
    top_idx = _top_k_indices(masked, k)
    top_scores = torch.gather(masked, 1, top_idx)
    valid = top_scores > NEG_INF_SCORE / 2

    boxes_k = torch.gather(box_xyxy, 1, top_idx[..., None].expand(-1, -1, 4))
    cls_k = torch.gather(class_pred, 1, top_idx)
    if class_agnostic:
        keep = nms_fixed(boxes_k, top_scores, nms_thre, valid)
    else:
        keep = batched_nms_fixed(boxes_k, top_scores, cls_k, nms_thre, valid)
    det = torch.cat([boxes_k,
                     torch.gather(obj, 1, top_idx)[..., None],
                     torch.gather(class_conf, 1, top_idx)[..., None],
                     cls_k[..., None].to(pred.dtype)], dim=-1)
    return _compact(det, keep, k, max_det)


def postprocess_fused(outputs, grid, stride, num_classes: int,
                      conf_thre: float = 0.7, nms_thre: float = 0.45,
                      class_agnostic: bool = False, max_det: int = 256):
    """Serving postprocess on the head's concatenated pre-decode outputs
    (`YoloxHead.forward_raw`: outputs (B, A, 5 + C), grid (A, 2), stride
    (A, 1)): every anchor is scored in the outputs' dtype, and only the
    top `max_det` candidates are decoded, in f32. Same output contract as
    `postprocess_device`, and bit-equal to it when `outputs` is f32."""
    masked, tbl = _score_and_payload(outputs, grid, stride, num_classes,
                                     conf_thre)
    return _select_decode_nms(masked, tbl, conf_thre, nms_thre,
                              class_agnostic, max_det)


def postprocess_fused_levels(outs, grids, strides, num_classes: int,
                             conf_thre: float = 0.7, nms_thre: float = 0.45,
                             class_agnostic: bool = False, max_det: int = 256):
    """Serving postprocess on the head's per-level pre-decode outputs
    (`YoloxHead.forward_raw_levels`): each level is reduced to its (B, A_l)
    masked score and (B, A_l, 10) payload before concatenation, and only
    the top `max_det` candidates are decoded, in f32. Same output contract
    as `postprocess_device`."""
    pieces = [_score_and_payload(o, g, s, num_classes, conf_thre)
              for o, g, s in zip(outs, grids, strides)]
    masked = torch.cat([m for m, _ in pieces], dim=1)
    tbl = torch.cat([t for _, t in pieces], dim=1)
    return _select_decode_nms(masked, tbl, conf_thre, nms_thre,
                              class_agnostic, max_det)


def _score_and_payload(outputs, grid, stride, num_classes, conf_thre):
    """(B, A) masked scores + (B, A, 10) candidate payload table
    (x, y, w, h, obj, cls_conf, cls_idx, gx, gy, stride)."""
    b, a = outputs.shape[0], outputs.shape[1]
    class_conf, class_pred = outputs[..., 5:5 + num_classes].max(dim=-1)
    score = outputs[..., 4] * class_conf
    masked = torch.where(score >= conf_thre, score,
                         torch.full_like(score, NEG_INF_SCORE))

    # The integer-valued columns (class index, grid, stride) must be exact
    # in the table's dtype: bf16 holds integers only up to 256, so the
    # table goes to f32 past 257 classes (the grid is f32 already past
    # 2048 px, `head.level_grid`).
    pdt = torch.promote_types(outputs.dtype, grid.dtype)
    if num_classes - 1 > exact_int_bound(pdt):
        pdt = torch.promote_types(pdt, torch.float32)
    tbl = torch.cat([
        outputs[..., :5].to(pdt),
        class_conf[..., None].to(pdt),
        class_pred.to(pdt)[..., None],
        grid.to(pdt)[None].expand(b, a, 2),
        stride.to(pdt)[None].expand(b, a, 1),
    ], dim=-1)
    return masked, tbl


def _select_decode_nms(masked, tbl, conf_thre, nms_thre, class_agnostic,
                       max_det):
    k = min(max_det, masked.shape[1])
    top_idx = _top_k_indices(masked, k)
    cand = torch.gather(tbl, 1, top_idx[..., None].expand(-1, -1, 10)).float()

    s = cand[..., 9:10]
    cxy = (cand[..., 0:2] + cand[..., 7:9]) * s
    wh = torch.exp(cand[..., 2:4]) * s
    box_xyxy = torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
    obj = cand[..., 4]
    class_conf_k = cand[..., 5]
    cls_k = cand[..., 6]
    top_scores = obj * class_conf_k
    valid = top_scores >= conf_thre

    if class_agnostic:
        keep = nms_fixed(box_xyxy, top_scores, nms_thre, valid)
    else:
        keep = batched_nms_fixed(box_xyxy, top_scores, cls_k, nms_thre, valid)
    det = torch.cat([box_xyxy, obj[..., None], class_conf_k[..., None],
                     cls_k[..., None]], dim=-1)
    return _compact(det, keep, k, max_det)
