"""PASCAL VOC AP evaluation, the port's copy of the JAX package's
`yolox_tpu/evaluators/voc_eval.py` (the classic Faster-RCNN `voc_eval`
protocol of upstream YOLOX): XML ground truth with a pickle cache, greedy
per-image matching with the VOC +1 pixel convention, 11-point (2007) or
precision-envelope AP. The matcher is vectorized per image (IoU matrices
+ per-image greedy sweeps) instead of the classic one-detection-at-a-time
loop; results are identical.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from collections import defaultdict
from typing import Dict, List

import numpy as np

from yolox_tpu_torch.utils.logger import logger


def parse_rec(filename):
    """Parse one PASCAL VOC xml annotation file into object dicts."""
    root = ET.parse(filename)
    out = []
    for node in root.findall("object"):
        box = node.find("bndbox")
        out.append({
            "name": node.find("name").text,
            "pose": getattr(node.find("pose"), "text", None),
            "truncated": int(getattr(node.find("truncated"), "text", 0) or 0),
            "difficult": int(getattr(node.find("difficult"), "text", 0) or 0),
            "bbox": [int(float(box.find(tag).text))
                     for tag in ("xmin", "ymin", "xmax", "ymax")],
        })
    return out


def _load_annotations(annopath, imagesetfile, cachedir):
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, "annots.pkl")
    with open(imagesetfile) as f:
        names = [line.strip() for line in f if line.strip()]
    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            return names, pickle.load(f)
    recs = {}
    for i, name in enumerate(names):
        recs[name] = parse_rec(annopath.format(name))
        if i % 1000 == 0:
            logger.info(f"Reading annotation for {i + 1}/{len(names)}")
    with open(cachefile, "wb") as f:
        pickle.dump(recs, f)
    return names, recs


def voc_ap(rec, prec, use_07_metric=False):
    """AP from precision/recall curves (11-point or envelope form)."""
    if use_07_metric:
        recall_points = np.arange(0.0, 1.1, 0.1)
        # max precision at recall >= t, vectorized over the 11 points
        mask = rec[None, :] >= recall_points[:, None]      # (11, N)
        p = np.where(mask.any(1),
                     np.where(mask, prec[None, :], 0.0).max(1), 0.0)
        return float(p.sum() / 11.0)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    # precision envelope: running max from the right
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    steps = np.flatnonzero(mrec[1:] != mrec[:-1])
    return float(np.sum((mrec[steps + 1] - mrec[steps]) * mpre[steps + 1]))


def _iou_one_to_many(box, gts):
    """IoU of one det box vs (G, 4) gt boxes, VOC +1 pixel areas."""
    lo = np.maximum(gts[:, :2], box[:2])
    hi = np.minimum(gts[:, 2:], box[2:])
    wh = np.maximum(hi - lo + 1.0, 0.0)
    inter = wh[:, 0] * wh[:, 1]
    area_d = (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
    area_g = (gts[:, 2] - gts[:, 0] + 1.0) * (gts[:, 3] - gts[:, 1] + 1.0)
    return inter / (area_d + area_g - inter)


def voc_eval(detpath, annopath, imagesetfile, classname, cachedir,
             ovthresh=0.5, use_07_metric=False):
    """Evaluate one class. Returns (recall, precision, ap)."""
    names, recs = _load_annotations(annopath, imagesetfile, cachedir)

    # per-image gt state for this class
    gt: Dict[str, dict] = {}
    npos = 0
    for name in names:
        objs = [o for o in recs[name] if o["name"] == classname]
        boxes = np.array([o["bbox"] for o in objs], np.float64)
        difficult = np.array([o["difficult"] for o in objs], bool)
        npos += int((~difficult).sum())
        gt[name] = {"boxes": boxes, "difficult": difficult,
                    "claimed": np.zeros(len(objs), bool)}

    with open(detpath.format(classname)) as f:
        rows = [line.strip().split(" ") for line in f if line.strip()]
    if not rows:
        return 0, 0, 0

    det_img = [r[0] for r in rows]
    scores = np.array([float(r[1]) for r in rows])
    det_boxes = np.array([[float(v) for v in r[2:6]] for r in rows])

    # global score ordering (the greedy sweep must claim gts in score
    # order across the whole dataset, as the protocol specifies)
    order = np.argsort(-scores)
    det_img = [det_img[i] for i in order]
    det_boxes = det_boxes[order]

    # group detection indices by image for cheap per-image access
    by_image: Dict[str, List[int]] = defaultdict(list)
    for idx, name in enumerate(det_img):
        by_image[name].append(idx)

    n = len(det_img)
    tp = np.zeros(n)
    fp = np.zeros(n)
    for name, idxs in by_image.items():
        state = gt[name]
        boxes = state["boxes"]
        if boxes.size == 0:
            fp[idxs] = 1.0
            continue
        # idxs are already in descending-score order (stable grouping of a
        # sorted list), so a linear sweep IS the greedy protocol
        for idx in idxs:
            ious = _iou_one_to_many(det_boxes[idx], boxes)
            j = int(np.argmax(ious))
            if ious[j] <= ovthresh:
                fp[idx] = 1.0
            elif state["difficult"][j]:
                pass  # difficult gts are ignored entirely
            elif state["claimed"][j]:
                fp[idx] = 1.0
            else:
                state["claimed"][j] = True
                tp[idx] = 1.0

    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    # npos == 0 (a class with no non-difficult gt) yields nan/inf recall —
    # the classic voc_eval's exact behavior (upstream `voc_eval.py:180`);
    # keep the values, silence the numpy warning noise
    with np.errstate(invalid="ignore", divide="ignore"):
        rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
