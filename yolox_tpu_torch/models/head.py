"""YOLOX decoupled head (NCHW), the PyTorch counterpart of the JAX package's
`yolox_tpu/models/head.py`.

Per pyramid level: 1x1 stem -> two branches of 2x(3x3 conv) -> 1x1 preds
for cls (num_classes) / reg (4) / obj (1). Inference decode:
(xy + grid) * stride, exp(wh) * stride. Rows leave the head in the JAX
layout (B, A, 5 + C), anchors row-major per level.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolox_tpu_torch.models.blocks import (
    BaseConv,
    DWConv,
    Int8Hooks,
    _set,
    init_children,
    init_conv_bias,
    init_conv_kernel,
)
from yolox_tpu_torch.ops import quant


def exact_int_bound(dtype: torch.dtype) -> int:
    """Largest N such that every integer in [0, N] is exactly representable
    in `dtype` (mantissa bits + 1 implied bit; 2**24 for f32)."""
    nmant = round(-math.log2(torch.finfo(dtype).eps))
    return 2 ** (nmant + 1)


def level_grid(hsize: int, wsize: int, dtype=torch.float32, device=None):
    """Anchor-center grid for one level: (h*w, 2) of (x=col, y=row),
    row-major. Kept in f32 when `dtype` cannot hold max(h, w) - 1 exactly
    (bf16 above 256 cells, i.e. inputs beyond 2048 px at stride 8)."""
    if max(hsize, wsize) - 1 > exact_int_bound(dtype):
        dtype = torch.float32
    # built on the device: a host copy here would stall serving's launches
    yv, xv = torch.meshgrid(torch.arange(hsize, device=device),
                            torch.arange(wsize, device=device), indexing="ij")
    return torch.stack((xv, yv), dim=2).reshape(hsize * wsize, 2).to(dtype)


class _PredConv(Int8Hooks, nn.Conv2d):
    """Plain 1x1 Conv2d with bias; `bias_fill` is the reference bias prior
    -log((1 - p) / p), p = 1e-2, which draws nothing from the generator.
    In the int8 HBM mode it reads the codes (`quant.pred_conv_hbm`: the
    input scale folded into the weight, the conv in bf16, not quantized)."""

    def __init__(self, cin, cout, bias_fill: Optional[float] = None):
        super().__init__(cin, cout, 1, 1, 0, bias=True)
        self.bias_fill = bias_fill

    def init_params(self, rng):
        _set(self.weight, init_conv_kernel(rng, 1, self.in_channels,
                                           self.out_channels))
        if self.bias_fill is not None:
            b = np.full((self.out_channels,), float(self.bias_fill),
                        np.float32)
        else:
            b = init_conv_bias(rng, 1, self.in_channels, self.out_channels)
        _set(self.bias, b)

    def forward(self, x):
        if self.int8_mode() == "hbm" and isinstance(x, quant.QTensor):
            return quant.pred_conv_hbm(x, self.weight, self.bias)
        # the weight takes the activation's dtype (f32 master weights of a
        # bf16 train step; a no-op when they agree)
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class YoloxHead(nn.Module):
    def __init__(
        self,
        num_classes: int,
        width: float = 1.0,
        strides: Sequence[int] = (8, 16, 32),
        in_channels: Sequence[int] = (256, 512, 1024),
        act: str = "silu",
        depthwise: bool = False,
        prior_prob: float = 1e-2,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.strides = list(strides)
        self.decode_in_inference = True
        Conv = DWConv if depthwise else BaseConv
        mid = int(256 * width)
        bias_prior = -math.log((1 - prior_prob) / prior_prob)

        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        self.stems = nn.ModuleList()
        for c in in_channels:
            self.stems.append(BaseConv(int(c * width), mid, 1, 1, act=act))
            self.cls_convs.append(nn.Sequential(
                Conv(mid, mid, 3, 1, act=act), Conv(mid, mid, 3, 1, act=act)))
            self.reg_convs.append(nn.Sequential(
                Conv(mid, mid, 3, 1, act=act), Conv(mid, mid, 3, 1, act=act)))
            self.cls_preds.append(_PredConv(mid, num_classes, bias_prior))
            self.reg_preds.append(_PredConv(mid, 4))
            self.obj_preds.append(_PredConv(mid, 1, bias_prior))

    def init_params(self, rng):
        # the JAX package's order: group by group, level by level
        for group in (self.stems, self.cls_convs, self.reg_convs,
                      self.cls_preds, self.reg_preds, self.obj_preds):
            for m in group:
                if isinstance(m, nn.Sequential):
                    init_children(rng, *m)
                else:
                    m.init_params(rng)

    def _level_outputs(self, xin):
        levels = []
        for k, x in enumerate(xin):
            x = self.stems[k](x)
            cls_feat = self.cls_convs[k](x)
            reg_feat = self.reg_convs[k](x)
            levels.append((self.reg_preds[k](reg_feat),
                           self.obj_preds[k](reg_feat),
                           self.cls_preds[k](cls_feat)))
        return levels

    def forward_raw_levels(self, xin):
        """Per-level pre-decode outputs: ([outputs_l], [grid_l], [stride_l]).

        outputs_l (B, h*w, 5+C) rows (tx, ty, tw, th, sigmoid(obj),
        sigmoid(cls)...), grid_l (h*w, 2), stride_l (h*w, 1). The fused
        serving postprocess reduces each level before concatenating.
        """
        outs, grids, strides = [], [], []
        for (reg, obj, cls), stride in zip(self._level_outputs(xin),
                                           self.strides):
            h, w = reg.shape[2:]
            out = torch.cat([reg, obj.sigmoid(), cls.sigmoid()], dim=1)
            outs.append(out.flatten(2).transpose(1, 2))
            grids.append(level_grid(h, w, out.dtype, out.device))
            strides.append(torch.full((h * w, 1), stride, dtype=out.dtype,
                                      device=out.device))
        return outs, grids, strides

    def forward_raw(self, xin):
        """`forward_raw_levels` concatenated over levels: (outputs (B, A,
        5+C), grid (A, 2), stride (A, 1))."""
        outs, grids, strides = self.forward_raw_levels(xin)
        return (torch.cat(outs, dim=1), torch.cat(grids, dim=0),
                torch.cat(strides, dim=0))

    def forward_train(self, xin):
        """Training forward (`head.py:212-242`). Returns a dict:
          outputs (B, A, 5+C): xy/wh decoded to image space, obj/cls raw
            logits, in the activation dtype;
          origin_reg (B, A, 4): raw reg predictions (grid space), for L1;
          x_shifts, y_shifts, expanded_strides (A,): per-anchor grid cell
            and stride.
        Anchors run row-major per level, levels in stride order 8, 16, 32.
        """
        outs, origin, xs, ys, es = [], [], [], [], []
        for (reg, obj, cls), stride in zip(self._level_outputs(xin),
                                           self.strides):
            h, w = reg.shape[2:]
            out = torch.cat([reg, obj, cls], dim=1).flatten(2).transpose(1, 2)
            grid = level_grid(h, w, out.dtype, out.device)
            xy = (out[..., 0:2] + grid[None]) * stride
            wh = torch.exp(out[..., 2:4]) * stride
            outs.append(torch.cat([xy, wh, out[..., 4:]], dim=-1))
            origin.append(reg.flatten(2).transpose(1, 2))
            xs.append(grid[:, 0])
            ys.append(grid[:, 1])
            es.append(torch.full((h * w,), stride, dtype=out.dtype,
                                 device=out.device))
        return {
            "outputs": torch.cat(outs, dim=1),
            "origin_reg": torch.cat(origin, dim=1),
            "x_shifts": torch.cat(xs),
            "y_shifts": torch.cat(ys),
            "expanded_strides": torch.cat(es),
        }

    def forward(self, xin):
        """Inference forward: decoded (B, n_anchors_all, 5 + num_classes),
        rows (cx, cy, w, h, sigmoid(obj), sigmoid(cls)...), anchors
        concatenated over levels in stride order (8, 16, 32)."""
        outputs, grid, stride = self.forward_raw(xin)
        if not self.decode_in_inference:
            return outputs
        grid, stride = grid[None], stride[None]
        return torch.cat([(outputs[..., 0:2] + grid) * stride,
                          torch.exp(outputs[..., 2:4]) * stride,
                          outputs[..., 4:]], dim=-1)
