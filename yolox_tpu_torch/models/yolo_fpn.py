"""Legacy YOLOv3 FPN (NCHW), the PyTorch counterpart of the JAX package's
`yolox_tpu/models/yolo_fpn.py`: a Darknet-53 backbone and lrelu embedding
blocks, with the same state-dict keys."""

from __future__ import annotations

import torch.nn as nn

from yolox_tpu_torch.models.blocks import (
    BaseConv,
    Int8Hooks,
    cat,
    init_children,
    upsample,
)
from yolox_tpu_torch.models.darknet import Darknet


class YoloFpn(Int8Hooks, nn.Module):
    """YOLOv3 FPN over a Darknet backbone (depth 53 by default)."""

    def __init__(self, depth=53, in_features=("dark3", "dark4", "dark5")):
        super().__init__()
        self.backbone = Darknet(depth)
        self.in_features = tuple(in_features)
        self.out1_cbl = self._cbl(512, 256, 1)
        self.out1 = self._embedding([256, 512], 512 + 256)
        self.out2_cbl = self._cbl(256, 128, 1)
        self.out2 = self._embedding([128, 256], 256 + 128)

    @staticmethod
    def _cbl(cin, cout, ks):
        return BaseConv(cin, cout, ks, stride=1, act="lrelu")

    def _embedding(self, filters_list, in_filters):
        return nn.Sequential(
            self._cbl(in_filters, filters_list[0], 1),
            self._cbl(filters_list[0], filters_list[1], 3),
            self._cbl(filters_list[1], filters_list[0], 1),
            self._cbl(filters_list[0], filters_list[1], 3),
            self._cbl(filters_list[1], filters_list[0], 1),
        )

    def init_params(self, rng):
        init_children(rng, self.backbone, self.out1_cbl, *self.out1,
                      self.out2_cbl, *self.out2)

    def forward(self, x):
        """x: the (B, H, W, 3) image. Returns NCHW (out_dark3, out_dark4,
        dark5) at strides 8, 16, 32."""
        out_features = self.backbone(x)
        x2, x1, x0 = [out_features[f] for f in self.in_features]
        # in the HBM mode upsample / cat act on QTensor codes and scales
        x1_in = cat(self, [upsample(self, self.out1_cbl(x0)), x1])
        out_dark4 = self.out1(x1_in)
        x2_in = cat(self, [upsample(self, self.out2_cbl(out_dark4)), x2])
        out_dark3 = self.out2(x2_in)
        return (out_dark3, out_dark4, x0)
