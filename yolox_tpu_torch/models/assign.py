"""SimOTA label assignment and the training losses, batched over images.

The PyTorch counterpart of the JAX package's `yolox_tpu/models/assign.py`
(semantics owner: the reference `yolo_head.py:253-574`). The batch is one
fixed-shape computation, as in JAX:

  - padded ground truth (B, M, 5) rows of (cls, cx, cy, w, h), zero rows
    are padding;
  - dense-exact over all A anchors by default; `num_candidates` compacts
    to the first N geometric candidates (index order);
  - dynamic-k through a fixed top-10 and a rank mask, ties to the lowest
    index (`_topk_iterative`: `torch.topk` promises no order on ties);
  - conflicts resolved by the first-index argmin of the cost over gts.

The module is split at the seam the tests and the step need:
`simota_assign` (no gradient) gives the assignment, `losses_given_assignment`
the losses for a given one, and `compute_losses` composes the two.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from yolox_tpu_torch.models.losses import bce_with_logits, iou_loss

BIG = 1e9          # excludes non-candidate anchors / padded gts from matching
GEOM_PENALTY = 1e6  # the reference's penalty for outside-center candidates
CENTER_RADIUS = 1.5
N_CANDIDATE_K = 10
NUM_CANDIDATES = None
REG_WEIGHT = 5.0


def _pairwise_iou_cxcywh(gt, pred):
    """IoU of gt (B, M, 4) x pred (B, N, 4), cxcywh -> (B, M, N), the
    reference formula: strict tl < br intersection, no eps."""
    g, p = gt[:, :, None, :], pred[:, None, :, :]
    tl = torch.maximum(g[..., :2] - g[..., 2:] / 2,
                       p[..., :2] - p[..., 2:] / 2)
    br = torch.minimum(g[..., :2] + g[..., 2:] / 2,
                       p[..., :2] + p[..., 2:] / 2)
    area_g = gt[..., 2] * gt[..., 3]
    area_p = pred[..., 2] * pred[..., 3]
    en = (tl < br).all(-1).to(gt.dtype)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * en
    return area_i / (area_g[:, :, None] + area_p[:, None, :] - area_i)


def _clamped_log(x):
    """log with torch BCE's -100 clamp (F.binary_cross_entropy)."""
    return torch.clamp(torch.log(x), min=-100.0)


def _topk_iterative(vals, k: int):
    """Top-k along the last axis, descending, ties to the lowest index
    (`lax.top_k`'s order): k passes of first-index argmax and mask."""
    v = vals.clone()
    out_v, out_i = [], []
    for _ in range(k):
        i = v.argmax(-1, keepdim=True)
        out_v.append(v.gather(-1, i))
        out_i.append(i)
        v.scatter_(-1, i, float("-inf"))
    return torch.cat(out_v, -1), torch.cat(out_i, -1)


@torch.no_grad()
def simota_assign(gt_labels, bbox_preds, obj_logits, cls_logits, x_shifts,
                  y_shifts, strides, num_classes: int,
                  num_candidates: Optional[int] = NUM_CANDIDATES
                  ) -> Dict[str, torch.Tensor]:
    """Batched SimOTA. gt_labels (B, M, 5); bbox_preds (B, A, 4) cxcywh in
    image space; obj_logits (B, A); cls_logits (B, A, C); x_shifts,
    y_shifts, strides (A,). All float32.

    Returns, with N = min(num_candidates, A) compacted slots (N = A dense):
      fg_mask (B, A) bool, matched_gt (B, A) int64 (0 where not fg),
      matched_iou (B, A) (0 where not fg), num_fg / num_gt / num_cand (B,),
      cand_idx (B, N) int64 anchor of each slot.
    """
    bsz, a = bbox_preds.shape[:2]
    m = gt_labels.shape[1]
    n = a if num_candidates is None else min(num_candidates, a)
    dev = bbox_preds.device
    gt_mask = gt_labels.sum(-1) > 0                               # (B, M)
    gt_cls = gt_labels[..., 0].long()
    gt_boxes = gt_labels[..., 1:5]

    # ---- geometry constraint (`yolo_head.py:511-540`) ----
    xc = (x_shifts + 0.5) * strides                               # (A,)
    yc = (y_shifts + 0.5) * strides
    radius = CENTER_RADIUS * strides

    def in_center_of(xc_, yc_, rad_):                             # (B, M, *)
        rad = rad_[..., None, :]
        return ((torch.abs(xc_[..., None, :] - gt_boxes[..., 0:1]) < rad)
                & (torch.abs(yc_[..., None, :] - gt_boxes[..., 1:2]) < rad)
                & gt_mask[..., None])

    in_center = in_center_of(xc, yc, radius)                      # (B, M, A)
    candidate = in_center.any(1)                                  # (B, A)

    # ---- compact candidates to N fixed slots ----
    dense = n >= a
    if dense:
        cand_idx = torch.arange(a, device=dev).expand(bsz, a)
        cand_valid = candidate
        preds_c, obj_c, cls_c = bbox_preds, obj_logits, cls_logits
    else:
        # true candidates first in index order, then the rest in index
        # order: lax.top_k of the 0/1 mask
        order = torch.sort(candidate.int(), dim=1, descending=True,
                           stable=True).indices
        cand_idx = order[:, :n]
        cand_valid = candidate.gather(1, cand_idx)
        preds_c = bbox_preds.gather(1, cand_idx[..., None].expand(-1, -1, 4))
        obj_c = obj_logits.gather(1, cand_idx)
        cls_c = cls_logits.gather(
            1, cand_idx[..., None].expand(-1, -1, cls_logits.shape[-1]))
        in_center = in_center_of(xc[cand_idx], yc[cand_idx], radius[cand_idx])
    slot_ok = cand_valid[:, None, :] & gt_mask[:, :, None]        # (B, M, N)

    # ---- pairwise IoU over candidates (`yolo_head.py:461`) ----
    ious = _pairwise_iou_cxcywh(gt_boxes, preds_c)
    ious = torch.where(slot_ok, ious, torch.zeros((), device=dev))

    # ---- classification cost (`yolo_head.py:472-480`) ----
    # sum_c BCE(p_c, onehot_g) = -sum_c log(1 - p_c) - log(p_g) + log(1 - p_g)
    p = torch.sqrt(torch.sigmoid(cls_c) * torch.sigmoid(obj_c)[..., None])
    log_p = _clamped_log(p)                                       # (B, N, C)
    log_1mp = _clamped_log(1.0 - p)
    s_neg = -log_1mp.sum(-1)                                      # (B, N)
    cls_idx = gt_cls[:, :, None].expand(-1, -1, n)                # (B, M, N)
    lp_g = log_p.transpose(1, 2).gather(1, cls_idx)
    l1mp_g = log_1mp.transpose(1, 2).gather(1, cls_idx)
    cls_cost = s_neg[:, None, :] - lp_g + l1mp_g

    iou_cost = -torch.log(ious + 1e-8)
    cost = (cls_cost + 3.0 * iou_cost
            + GEOM_PENALTY * (~in_center).to(cls_cost.dtype))
    cost = torch.where(slot_ok, cost, torch.full((), BIG, device=dev))

    # ---- dynamic-k matching (`yolo_head.py:542-574`) ----
    k_pool = min(N_CANDIDATE_K, n)
    topk_ious, _ = _topk_iterative(ious, k_pool)                  # (B, M, k)
    dynamic_ks = topk_ious.sum(-1).int().clamp(min=1)
    neg_cost_topv, topk_idx = _topk_iterative(-cost, k_pool)
    rank = torch.arange(k_pool, device=dev)
    select = (rank < dynamic_ks[..., None]) & gt_mask[..., None]
    select &= neg_cost_topv > -BIG / 2
    # the top-k indices of a row are distinct, so a scatter sets each once
    matching = torch.zeros((bsz, m, n), dtype=torch.bool, device=dev)
    matching.scatter_(2, topk_idx, select)

    # conflict resolution: a slot matched by > 1 gt keeps the argmin cost
    n_match = matching.sum(1)                                     # (B, N)
    best_gt = torch.where(matching, cost, torch.full((), BIG, device=dev)
                          ).argmin(1)                             # (B, N)
    onehot_best = (torch.arange(m, device=dev)[None, :, None]
                   == best_gt[:, None])
    matching = torch.where(n_match[:, None] > 1, onehot_best, matching)

    fg_cand = matching.any(1)                                     # (B, N)
    matched_gt_cand = matching.int().argmax(1)
    matched_iou_cand = torch.where(matching, ious,
                                   torch.zeros((), device=dev)).sum(1)

    # ---- scatter candidate results back to anchor space ----
    fg_mask = fg_cand
    matched_gt = torch.where(fg_cand, matched_gt_cand, 0)
    matched_iou = torch.where(fg_cand, matched_iou_cand, 0.0)
    if not dense:
        zeros = torch.zeros((bsz, a), device=dev)
        fg_mask = zeros.bool().scatter(1, cand_idx, fg_mask)
        matched_gt = zeros.long().scatter(1, cand_idx, matched_gt)
        matched_iou = zeros.to(ious.dtype).scatter(1, cand_idx, matched_iou)
    return {
        "fg_mask": fg_mask,
        "matched_gt": matched_gt,
        "matched_iou": matched_iou,
        "num_fg": fg_cand.sum(1).float(),
        "num_gt": gt_mask.sum(1).float(),
        "num_cand": candidate.sum(1).float(),
        "cand_idx": cand_idx,
    }


def _head_tensors(head_out):
    """Head outputs promoted to float32 (`assign.py:266`)."""
    outputs = head_out["outputs"].float()
    return (outputs[..., :4], outputs[..., 4], outputs[..., 5:],
            head_out["x_shifts"].float(), head_out["y_shifts"].float(),
            head_out["expanded_strides"].float())


def assign_batch(head_out, labels, num_classes: int,
                 num_candidates: Optional[int] = NUM_CANDIDATES):
    """SimOTA on `YoloxHead.forward_train` outputs, detached."""
    bbox, obj, cls, xs, ys, st = _head_tensors(head_out)
    return simota_assign(labels.float(), bbox.detach(), obj.detach(),
                         cls.detach(), xs, ys, st, num_classes,
                         num_candidates)


def losses_given_assignment(head_out, labels, assign, num_classes: int,
                            use_l1: bool = False) -> Dict[str, torch.Tensor]:
    """The YOLOX losses (`yolo_head.py:253-411`) for a given assignment,
    summed densely over all anchors and masked by fg (zero off fg).

    Returns total_loss, iou_loss, l1_loss, conf_loss, cls_loss, num_fg
    (fg per gt) and cand_overflow (the share of images whose candidates
    overflowed the compaction cap)."""
    bbox_preds, obj_logits, cls_logits, x_shifts, y_shifts, strides = \
        _head_tensors(head_out)
    labels = labels.float()
    fg_f = assign["fg_mask"].float()                              # (B, A)
    matched_gt = assign["matched_gt"]
    num_fg_total = assign["num_fg"].sum().clamp(min=1.0)
    num_gts_total = assign["num_gt"].sum().clamp(min=1.0)

    gt_boxes = labels[..., 1:5]                                   # (B, M, 4)
    gt_cls = labels[..., 0].long()                                # (B, M)
    reg_target = gt_boxes.gather(1, matched_gt[..., None].expand(-1, -1, 4))
    cls_target = (F.one_hot(gt_cls.gather(1, matched_gt), num_classes).float()
                  * assign["matched_iou"][..., None])             # (B, A, C)

    loss_iou = (iou_loss(bbox_preds, reg_target) * fg_f).sum() / num_fg_total
    loss_obj = bce_with_logits(obj_logits, fg_f).sum() / num_fg_total
    loss_cls = (bce_with_logits(cls_logits, cls_target).sum(-1)
                * fg_f).sum() / num_fg_total

    if use_l1:
        # grid-space L1 target (`yolo_head.py:413-418`)
        eps = 1e-8
        l1_target = torch.stack([
            reg_target[..., 0] / strides - x_shifts,
            reg_target[..., 1] / strides - y_shifts,
            torch.log(reg_target[..., 2] / strides + eps),
            torch.log(reg_target[..., 3] / strides + eps),
        ], -1)
        origin_reg = head_out["origin_reg"].float()
        loss_l1 = ((origin_reg - l1_target).abs().sum(-1)
                   * fg_f).sum() / num_fg_total
    else:
        loss_l1 = torch.zeros((), device=fg_f.device)

    total = REG_WEIGHT * loss_iou + loss_obj + loss_cls + loss_l1
    return {
        "total_loss": total,
        "iou_loss": REG_WEIGHT * loss_iou,
        "l1_loss": loss_l1,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "num_fg": assign["num_fg"].sum() / num_gts_total,
        "cand_overflow": (assign["num_cand"]
                          > assign["cand_idx"].shape[-1]).float().mean(),
    }


def compute_losses(head_out, labels, num_classes: int, use_l1: bool = False,
                   num_candidates: Optional[int] = NUM_CANDIDATES
                   ) -> Dict[str, torch.Tensor]:
    """Batched YOLOX losses: SimOTA, then the losses given its result."""
    assign = assign_batch(head_out, labels, num_classes, num_candidates)
    return losses_given_assignment(head_out, labels, assign, num_classes,
                                   use_l1)
