"""The comparison that decides a serving cell's `correct`.

For each compared image the program gave detections P, rows (x1, y1, x2,
y2, score, class) with score = obj * class confidence, and the float32
reference gave its decoded anchors D: (cx, cy, w, h, obj, cls_0..cls_C-1).
Each detection of P is paired with the anchor of D whose box is nearest
its own by the box gap below (the anchor it was decoded from: no two
anchors decode to nearly the same box). Three numbers over all compared
images:

- score_gap_mean: the mean over P of |score - the paired anchor's obj *
  cls of P's class|: the precision the program computes in. (The widest
  gap is no number here: a few anchors of a seeded network move by
  rounding as far as the control moves them.)
- box_off_share: the share of P whose box gap to its paired anchor
  passes 0.5. A box gap is the centres' offset over the anchor box's
  larger side (at least 8 px, so that a sliver a rounding moves by less
  than a pixel reads small) plus the larger |log| ratio of widths and of
  heights. A detection no anchor explains, or one altered after it was
  made, reads past 1. (The widest gap is no number here, for the reason
  the widest score gap is not.)
- missing: the share of the reference's required detections that P lacks
  (no detection of the same class at IoU >= 0.5). The reference runs the
  postprocess itself (`reference/postprocess.detect`) over the anchors
  that score at least threshold - margin; a detection is required unless
  rounding may move it: its score lies within `margin` of the threshold,
  another candidate of its class scores within `margin` below it or
  higher and overlaps it by more than the NMS threshold less
  `iou_margin`, its anchor's second class scores within `margin` of it,
  or it ranks within `margin` of the max_det-th candidate's score.

`margin` and `iou_margin` are the cell's `margins`. A frame in which the
reference finds an ill-conditioned candidate (a box side outside [0.5,
2560] px, see ILL_MIN) is counted apart (`ill_conditioned_images`) and
left out of all three.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.postprocess import box_xyxy, detect, iou_matrix

NUMBERS = ("score_gap_mean", "box_off_share", "missing")
BOX_OFF = 0.5  # a box gap past half a side (or a size ratio of e^0.5)


MIN_SIDE = 8.0  # px: the finest stride; a sliver box is measured at it
# a reference box with a side outside [ILL_MIN, ILL_MAX] px is the exp()
# of an extreme size logit: the seeded network is out of its calibrated
# range in that frame (rounding moves such logits by whole units, and the
# frame's other candidates with them), and no trained one puts a box
# there. A frame whose reference candidates hold one is counted apart.
ILL_MIN, ILL_MAX = 0.5, 2560.0
CHUNK = 256
# boxes are compared clipped to this many px: exp() of a seeded network's
# largest size logits overflows float32 on both sides alike
FAR = 1e6


def _centre_size(boxes):
    """(N, 4) corners -> centres (N, 2) and sizes (N, 2), sizes at least
    a thousandth of a pixel."""
    return (boxes[:, :2] + boxes[:, 2:]) / 2, \
        (boxes[:, 2:] - boxes[:, :2]).clamp_min(1e-3)


def ill_conditioned(sizes):
    """Boxes (N, 2) sizes whose side lies outside [ILL_MIN, ILL_MAX]."""
    return (sizes.amin(-1) < ILL_MIN) | (sizes.amax(-1) > ILL_MAX)


def pair_gaps(prog: np.ndarray, decoded: torch.Tensor):
    """(sum of |score gaps|, detections whose box gap passes BOX_OFF) of P
    against the anchors of
    one image's decoded output (on any device). A detection's box gap to
    an anchor is its centre's offset over the anchor box's larger side
    (at least MIN_SIDE) plus the larger |log| ratio of their widths and
    heights: scale-free, so that a box that an extreme size logit made
    huge is measured by how far rounding moved the logit. Each detection
    pairs with the anchor of least box gap."""
    if not len(prog):
        return 0.0, 0
    d = decoded.double()
    boxes = box_xyxy(d).nan_to_num(FAR, FAR, -FAR).clamp(-FAR, FAR)
    rc, rs = _centre_size(boxes)
    side = rs.amax(-1).clamp_min(MIN_SIDE)
    p = torch.from_numpy(prog).to(d)
    p[:, :4] = p[:, :4].nan_to_num(FAR, FAR, -FAR).clamp(-FAR, FAR)
    gap_sum, box_off = 0.0, 0
    for i in range(0, len(p), CHUNK):
        q = p[i:i + CHUNK]
        qc, qs = _centre_size(q[:, :4])
        cost = ((qc[:, None] - rc[None]).abs().amax(-1) / side[None]
                + (qs[:, None].log() - rs[None].log()).abs().amax(-1))
        gaps, best = cost.min(1)
        cls = q[:, 5].long().clamp(0, d.shape[1] - 6)
        s_ref = d[best, 4] * d[best, 5 + cls]
        gap_sum += float((s_ref - q[:, 4]).abs().sum())
        box_off += int((gaps.nan_to_num(1e9) > BOX_OFF).sum())
    return gap_sum, box_off


def candidate_rows(decoded: torch.Tensor, conf_thr: float, margin: float):
    """The rows of one image's decoded (A, 5 + C) output that any class
    scores at least conf_thr - margin on, as float64 numpy."""
    score = decoded[:, 4:5] * decoded[:, 5:]
    keep = (score >= conf_thr - margin).any(1)
    return decoded[keep].double().cpu().numpy()


def missing(prog: np.ndarray, ref: np.ndarray, conf_thr: float,
            nms_thr: float, max_det: int, margin: float,
            iou_margin: float):
    """(required, missing) of one image: ref its `candidate_rows`."""
    if not len(ref):
        return 0, 0
    ref_boxes = np.clip(np.nan_to_num(box_xyxy(torch.from_numpy(ref))
                                      .numpy(), nan=FAR), -FAR, FAR)
    prog = prog.copy()
    prog[:, :4] = np.clip(np.nan_to_num(prog[:, :4], nan=FAR), -FAR, FAR)
    scores = ref[:, 4:5] * ref[:, 5:]                           # (m, C)
    best = scores.max(1)
    ranked = np.sort(best[best >= conf_thr])[::-1]
    cut = ranked[max_det - 1] if len(ranked) >= max_det else -np.inf
    second = np.sort(scores, 1)[:, -2]
    dets = detect(torch.from_numpy(ref[None]), conf_thr, nms_thr, max_det)[0]
    required = lost = 0
    dets[:, :4] = np.clip(np.nan_to_num(dets[:, :4], nan=FAR), -FAR, FAR)
    for r in dets:
        s, c = r[4] * r[5], int(r[6])
        if s < conf_thr + margin or s < cut + margin:
            continue
        iou = iou_matrix(r[None, :4], ref_boxes)[0]
        own = np.nonzero((np.abs(ref_boxes - r[:4]).max(1) == 0)
                         & (scores[:, c] == s))[0]
        rivals = (scores[:, c] > s - margin) & (iou > nms_thr - iou_margin)
        rivals[own] = False
        if rivals.any() or (len(own) and second[own[0]] > s - margin):
            continue
        required += 1
        same = prog[prog[:, 5] == c]
        if not len(same) or iou_matrix(r[None, :4], same[:, :4]).max() < 0.5:
            lost += 1
    return required, lost


class Tally:
    """The numbers over the compared images, with counts."""

    def __init__(self):
        self.gap_sum = 0.0
        self.box_off = 0
        self.required = self.missing = self.detections = 0
        self.candidates = self.images = self.ill_images = 0

    def add(self, prog, decoded, cand_rows, conf_thr, nms_thr, max_det,
            margin, iou_margin):
        if len(cand_rows) and bool(ill_conditioned(_centre_size(
                box_xyxy(torch.from_numpy(cand_rows)))[1]).any()):
            self.ill_images += 1
            return
        gap_sum, box_off = pair_gaps(prog, decoded)
        req, lost = missing(prog, cand_rows, conf_thr, nms_thr, max_det,
                            margin, iou_margin)
        self.gap_sum += gap_sum
        self.box_off += box_off
        self.required += req
        self.missing += lost
        self.detections += len(prog)
        self.images += 1
        if len(cand_rows):
            s = (cand_rows[:, 4:5] * cand_rows[:, 5:]).max(1)
            self.candidates += int((s >= conf_thr).sum())

    def numbers(self) -> dict:
        return {"score_gap_mean": self.gap_sum / max(self.detections, 1),
                "box_off_share": self.box_off / max(self.detections, 1),
                "missing": self.missing / max(self.required, 1)}

    def counts(self) -> dict:
        return {"images": self.images, "required": self.required,
                "detections": self.detections,
                "ill_conditioned_images": self.ill_images,
                "candidates": self.candidates}


def judge(numbers: dict, images: int, limits: dict):
    """({number: {"value", "limit"}}, correct); a run that compared no
    image is not correct."""
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = images > 0 and all(v["value"] <= v["limit"] for v in check.values())
    return check, ok
