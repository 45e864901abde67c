"""The plain reference of YOLOX's postprocess and of the letterbox.

- `detect`: upstream `yolox/utils/boxes.py::postprocess` on the decoded
  output: score = obj * best class confidence, candidates with score >=
  the threshold, at most `max_det` of them by score, then greedy
  class-aware NMS with torchvision's semantics (`batched_nms`: stable sort
  by score, suppress on IoU strictly above the threshold, classes kept
  apart). Written as a loop over the candidates of one image in float64.
- `letterbox`: upstream `yolox/data/data_augment.py::preproc`: scale by
  r = min(640 / h, 640 / w), INTER_LINEAR resize to (int(w r), int(h r)),
  paste at the top-left of a 114-filled canvas. cv2 resizes where it
  imports; otherwise the resize is the half-pixel bilinear filter in
  float64, rounded to the nearest level, which may differ from cv2's
  fixed-point sums by one level. A frame already at the target scale is
  pasted as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def box_xyxy(decoded: torch.Tensor) -> torch.Tensor:
    """(..., >=4) rows (cx, cy, w, h, ...) -> (..., 4) corners."""
    cx, cy, w, h = decoded[..., 0], decoded[..., 1], decoded[..., 2], \
        decoded[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of every box of a (N, 4) against every box of b (M, 4)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return np.nan_to_num(iou, nan=0.0, posinf=0.0, neginf=0.0)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray,
               iou_thr: float) -> np.ndarray:
    """Indices kept by class-aware greedy NMS, in descending score order
    (ties: lower index first)."""
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros(len(order), bool)
    keep = []
    iou = iou_matrix(boxes[order], boxes[order])
    same = classes[order][:, None] == classes[order][None, :]
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        suppressed |= (iou[i] > iou_thr) & same[i]
    return np.asarray(keep, np.int64)


def detect(decoded: torch.Tensor, conf_thr: float, nms_thr: float,
           max_det: int):
    """Per image of a (B, A, 5 + C) decoded batch: an (n, 7) float64 array
    of rows (x1, y1, x2, y2, obj, cls_conf, cls) in descending score."""
    out = []
    for d in decoded.double().cpu().numpy():
        cls_conf = d[:, 5:].max(1)
        cls = d[:, 5:].argmax(1)
        score = d[:, 4] * cls_conf
        cand = np.nonzero(score >= conf_thr)[0]
        cand = cand[np.argsort(-score[cand], kind="stable")][:max_det]
        boxes = box_xyxy(torch.from_numpy(d[cand])).numpy()
        keep = cand[greedy_nms(boxes, score[cand], cls[cand], nms_thr)]
        rows = np.concatenate([box_xyxy(torch.from_numpy(d[keep])).numpy(),
                               d[keep, 4:5], cls_conf[keep, None],
                               cls[keep, None].astype(np.float64)], 1)
        out.append(rows.reshape(-1, 7))
    return out


def _resize_bilinear(img: np.ndarray, size_wh) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR)
    w, h = size_wh
    src_h, src_w = img.shape[:2]

    def taps(n_out, n_in):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0, n_in - 1)
        x0 = np.floor(x).astype(np.int64)
        x1 = np.minimum(x0 + 1, n_in - 1)
        return x0, x1, x - x0

    y0, y1, fy = taps(h, src_h)
    x0, x1, fx = taps(w, src_w)
    f = img.astype(np.float64)
    rows = f[y0] * (1 - fy)[:, None, None] + f[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :,
                                                                     None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def letterbox(img: np.ndarray, size=(640, 640)):
    """HWC uint8 frame -> (size[0], size[1], 3) uint8 canvas, ratio r."""
    h, w = img.shape[:2]
    r = min(size[0] / h, size[1] / w)
    new_wh = (int(w * r), int(h * r))
    resized = img if new_wh == (w, h) else _resize_bilinear(img, new_wh)
    canvas = np.full((size[0], size[1], 3), 114, np.uint8)
    canvas[:new_wh[1], :new_wh[0]] = resized
    return canvas, r
