"""Deploy-time (export/demo) numpy postprocessing, the PyTorch port's copy
of the JAX package's `yolox_tpu/utils/demo_utils.py`: numpy NMS
(class-aware and class-agnostic) and the grid decode of raw (undecoded)
outputs, for exported programs that do not carry the decode
(`yolox-tpu-torch export --no-decode`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["nms", "multiclass_nms", "demo_postprocess"]


def nms(boxes, scores, nms_thr):
    """Single-class numpy NMS; returns kept indices (score order)."""
    x1, y1 = boxes[:, 0], boxes[:, 1]
    x2, y2 = boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]

    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        inds = np.where(ovr <= nms_thr)[0]
        order = order[inds + 1]
    return keep


def multiclass_nms(boxes, scores, nms_thr, score_thr, class_agnostic=False):
    """Multiclass NMS over (N, 4) boxes and (N, C) scores.

    Returns (M, 6) rows (x1, y1, x2, y2, score, cls) or None.
    """
    if class_agnostic:
        cls_inds = scores.argmax(1)
        cls_scores = scores[np.arange(len(cls_inds)), cls_inds]
        valid = cls_scores > score_thr
        if valid.sum() == 0:
            return None
        vb, vs, vc = boxes[valid], cls_scores[valid], cls_inds[valid]
        keep = nms(vb, vs, nms_thr)
        if not keep:
            return None
        return np.concatenate(
            [vb[keep], vs[keep, None], vc[keep, None].astype(np.float32)],
            axis=1)

    final = []
    num_classes = scores.shape[1]
    for cls_ind in range(num_classes):
        cls_scores = scores[:, cls_ind]
        valid = cls_scores > score_thr
        if valid.sum() == 0:
            continue
        vb, vs = boxes[valid], cls_scores[valid]
        keep = nms(vb, vs, nms_thr)
        if keep:
            cls_col = np.full((len(keep), 1), cls_ind, np.float32)
            final.append(np.concatenate(
                [vb[keep], vs[keep, None], cls_col], axis=1))
    if not final:
        return None
    return np.concatenate(final, 0)


def demo_postprocess(outputs, img_size, p6=False):
    """Grid-decode raw (B, A, 5+C) outputs in numpy
    (`demo_utils.py:138-158`): (xy + grid) * stride, exp(wh) * stride."""
    grids = []
    expanded_strides = []
    strides = [8, 16, 32] if not p6 else [8, 16, 32, 64]

    hsizes = [img_size[0] // s for s in strides]
    wsizes = [img_size[1] // s for s in strides]

    for hsize, wsize, stride in zip(hsizes, wsizes, strides):
        xv, yv = np.meshgrid(np.arange(wsize), np.arange(hsize))
        grid = np.stack((xv, yv), 2).reshape(1, -1, 2)
        grids.append(grid)
        expanded_strides.append(np.full((*grid.shape[:2], 1), stride))

    grids = np.concatenate(grids, 1)
    expanded_strides = np.concatenate(expanded_strides, 1)
    outputs = outputs.copy()
    outputs[..., :2] = (outputs[..., :2] + grids) * expanded_strides
    outputs[..., 2:4] = np.exp(outputs[..., 2:4]) * expanded_strides
    return outputs
