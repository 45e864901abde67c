"""PAFPN neck (NCHW), the PyTorch counterpart of the JAX package's
`yolox_tpu/models/pafpn.py`.

Top-down FPN + bottom-up PAN over (dark3, dark4, dark5); nearest 2x
upsampling; outputs three pyramid levels at strides (8, 16, 32). Under
`remat` each CSPLayer is a stage (`blocks.RematStages`), as the backbone's
dark stages are.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from yolox_tpu_torch.models.blocks import (
    BaseConv,
    CspLayer,
    DWConv,
    Int8Hooks,
    RematStages,
    cat,
    init_children,
    upsample,
)
from yolox_tpu_torch.models.darknet import CspDarknet


class YoloPafpn(RematStages, Int8Hooks, nn.Module):
    def __init__(
        self,
        depth: float = 1.0,
        width: float = 1.0,
        in_features: Sequence[str] = ("dark3", "dark4", "dark5"),
        in_channels: Sequence[int] = (256, 512, 1024),
        depthwise: bool = False,
        act: str = "silu",
    ):
        super().__init__()
        self.backbone = CspDarknet(depth, width, depthwise=depthwise, act=act)
        self.in_features = tuple(in_features)
        self.in_channels = tuple(in_channels)
        Conv = DWConv if depthwise else BaseConv
        c0, c1, c2 = (int(c * width) for c in in_channels)
        n = round(3 * depth)

        self.lateral_conv0 = BaseConv(c2, c1, 1, 1, act=act)
        self.C3_p4 = CspLayer(2 * c1, c1, n, False, depthwise=depthwise,
                              act=act)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, act=act)
        self.C3_p3 = CspLayer(2 * c0, c0, n, False, depthwise=depthwise,
                              act=act)
        self.bu_conv2 = Conv(c0, c0, 3, 2, act=act)
        self.C3_n3 = CspLayer(2 * c0, c1, n, False, depthwise=depthwise,
                              act=act)
        self.bu_conv1 = Conv(c1, c1, 3, 2, act=act)
        self.C3_n4 = CspLayer(2 * c1, c2, n, False, depthwise=depthwise,
                              act=act)

    def init_params(self, rng):
        init_children(rng, self.backbone, self.lateral_conv0, self.C3_p4,
                      self.reduce_conv1, self.C3_p3, self.bu_conv2,
                      self.C3_n3, self.bu_conv1, self.C3_n4)

    def forward(self, x):
        """x: the (B, H, W, 3) image. Returns NCHW (pan_out2, pan_out1,
        pan_out0) at strides 8, 16, 32."""
        out_features = self.backbone(x)
        x2, x1, x0 = [out_features[f] for f in self.in_features]

        # in the HBM mode upsample / cat act on QTensor codes and scales
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = cat(self, [upsample(self, fpn_out0), x1])
        f_out0 = self.stage(self.C3_p4, f_out0)

        fpn_out1 = self.reduce_conv1(f_out0)
        f_out1 = cat(self, [upsample(self, fpn_out1), x2])
        pan_out2 = self.stage(self.C3_p3, f_out1)

        p_out1 = cat(self, [self.bu_conv2(pan_out2), fpn_out1])
        pan_out1 = self.stage(self.C3_n3, p_out1)

        p_out0 = cat(self, [self.bu_conv1(pan_out1), fpn_out0])
        pan_out0 = self.stage(self.C3_n4, p_out0)
        return (pan_out2, pan_out1, pan_out0)
