"""Detection losses, the PyTorch counterpart of the JAX package's
`yolox_tpu/models/losses.py`: elementwise functions over matched
(pred, target) pairs in cxcywh format.
"""

from __future__ import annotations

import torch


def iou_loss(pred, target, loss_type: str = "iou", eps: float = 1e-7):
    """Elementwise IoU loss for matched cxcywh boxes (`losses.py:21-51`).

    loss_type "iou": 1 - iou^2;  "giou": 1 - clamp(giou, -1, 1).
    Returns the per-pair loss (no reduction).
    """
    px, py, pw, ph = pred.unbind(-1)
    tx, ty, tw, th = target.unbind(-1)

    tl_x = torch.maximum(px - pw / 2, tx - tw / 2)
    tl_y = torch.maximum(py - ph / 2, ty - th / 2)
    br_x = torch.minimum(px + pw / 2, tx + tw / 2)
    br_y = torch.minimum(py + ph / 2, ty + th / 2)

    area_p = pw * ph
    area_g = tw * th

    en = ((tl_x < br_x) & (tl_y < br_y)).to(pred.dtype)
    area_i = (br_x - tl_x) * (br_y - tl_y) * en
    area_u = area_p + area_g - area_i
    iou = area_i / (area_u + eps)

    if loss_type == "iou":
        return 1 - iou ** 2
    if loss_type == "giou":
        c_w = (torch.maximum(px + pw / 2, tx + tw / 2)
               - torch.minimum(px - pw / 2, tx - tw / 2))
        c_h = (torch.maximum(py + ph / 2, ty + th / 2)
               - torch.minimum(py - ph / 2, ty - th / 2))
        area_c = c_w * c_h
        giou = iou - (area_c - area_u) / area_c.clamp(min=eps)
        return 1 - giou.clamp(-1.0, 1.0)
    raise ValueError(f"unknown loss_type: {loss_type}")


class _BceWithLogits(torch.autograd.Function):
    """BCEWithLogitsLoss(reduction='none') with the closed-form gradient:
    d/dlogits = sigmoid(logits) - targets, d/dtargets = -logits (the JAX
    package's custom_jvp, `losses.py:52-69`)."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        return (torch.clamp(logits, min=0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))

    @staticmethod
    def backward(ctx, grad):
        logits, targets = ctx.saved_tensors
        g_logits = g_targets = None
        if ctx.needs_input_grad[0]:
            g_logits = (torch.sigmoid(logits) - targets) * grad
        if ctx.needs_input_grad[1]:
            g_targets = -logits * grad
        return g_logits, g_targets


def bce_with_logits(logits, targets):
    """BCEWithLogitsLoss(reduction='none'), numerically stable."""
    return _BceWithLogits.apply(logits, targets)
