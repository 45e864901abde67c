"""Detection and SimOTA-assignment drawing, the PyTorch port's copy of the
JAX package's `yolox_tpu/utils/visualize.py` (the same procedural
80-class palette: golden-ratio hue steps in HSV, stable per class index,
and the same cv2 drawing calls, so both packages draw the same pixels).
Drawing needs cv2.
"""

from __future__ import annotations

import colorsys

import numpy as np

from yolox_tpu_torch.data.datasets import COCO_CLASSES

__all__ = ["vis", "class_color", "visualize_assign"]


def _make_palette(n: int = 256) -> np.ndarray:
    colors = []
    golden = 0.61803398875
    h = 0.12
    for i in range(n):
        h = (h + golden) % 1.0
        s = 0.65 + 0.35 * ((i * 7) % 3) / 2.0
        v = 0.75 + 0.25 * ((i * 5) % 2)
        colors.append(colorsys.hsv_to_rgb(h, s, v))
    return np.asarray(colors, np.float32)


_COLORS = _make_palette()


def class_color(cls_id: int, bgr: bool = False):
    c = (_COLORS[cls_id % len(_COLORS)] * 255).astype(np.uint8).tolist()
    return c[::-1] if bgr else c


def vis(img, boxes, scores, cls_ids, conf=0.5, class_names=COCO_CLASSES):
    """Draw boxes + class/score labels on a BGR uint8 image (in place)."""
    import cv2

    img = np.ascontiguousarray(img)
    for i in range(len(boxes)):
        box = boxes[i]
        cls_id = int(cls_ids[i])
        score = float(scores[i])
        if score < conf:
            continue
        x0, y0, x1, y1 = (int(v) for v in box[:4])
        color = class_color(cls_id, bgr=True)
        text = f"{class_names[cls_id]}:{score * 100:.1f}%"
        txt_color = ((0, 0, 0)
                     if sum(color) > 382 else (255, 255, 255))
        font = cv2.FONT_HERSHEY_SIMPLEX
        txt_size = cv2.getTextSize(text, font, 0.4, 1)[0]
        cv2.rectangle(img, (x0, y0), (x1, y1), color, 2)
        bg = [int(c * 0.7) for c in color]
        cv2.rectangle(
            img, (x0, y0 + 1),
            (x0 + txt_size[0] + 1, y0 + int(1.5 * txt_size[1])), bg, -1)
        cv2.putText(img, text, (x0, y0 + txt_size[1]), font, 0.4,
                    txt_color, thickness=1)
    return img


def visualize_assign(img, boxes, coords, match_results, save_name=None):
    """Draw gt boxes and the anchor centers SimOTA assigned to each
    (one color per gt). boxes: (G, 4) xyxy; coords: (N, 2) anchor centers;
    match_results: (N,) matched gt index."""
    import cv2

    img = np.ascontiguousarray(np.asarray(img), dtype=np.uint8)
    boxes = np.asarray(boxes)
    coords = np.asarray(coords)
    match_results = np.asarray(match_results)
    for box_id, box in enumerate(boxes):
        x1, y1, x2, y2 = (int(v) for v in box[:4])
        color = class_color(box_id, bgr=True)
        assigned = coords[match_results == box_id]
        if len(assigned) == 0:  # unmatched gt drawn in red (reference style)
            color = (0, 0, 255)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 1)
        for coord in assigned:
            cv2.circle(img, (int(coord[0]), int(coord[1])), 3, color, -1)
    if save_name is not None:
        cv2.imwrite(save_name, img)
    return img
