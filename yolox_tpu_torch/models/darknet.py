"""CSPDarknet backbone (NCHW), the PyTorch counterpart of the JAX package's
`yolox_tpu/models/darknet.py::CspDarknet`: the same topology and state-dict
keys. The Focus stem takes the NHWC image and runs as the stem kernel K1;
every later stage is NCHW.
"""

from __future__ import annotations

import torch.nn as nn

from yolox_tpu_torch.models.blocks import (
    BaseConv,
    CspLayer,
    DWConv,
    Focus,
    SPPBottleneck,
    init_children,
)


class CspDarknet(nn.Module):
    """CSPDarknet backbone (`darknet.py:95-177`): Focus stem, dark2..dark5.

    Widths 64*w*{1,2,4,8,16}; depths round(3*d)*{1,3,3,1}; SPP in dark5.
    Takes the (B, H, W, 3) image and returns a dict of the requested
    NCHW feature maps.
    """

    def __init__(self, dep_mul, wid_mul,
                 out_features=("dark3", "dark4", "dark5"),
                 depthwise=False, act="silu"):
        super().__init__()
        if not out_features:
            raise ValueError("please provide output features of Darknet")
        self.out_features = tuple(out_features)
        Conv = DWConv if depthwise else BaseConv

        base_channels = int(wid_mul * 64)
        base_depth = max(round(dep_mul * 3), 1)

        self.stem = Focus(3, base_channels, ksize=3, act=act)
        self.dark2 = nn.Sequential(
            Conv(base_channels, base_channels * 2, 3, 2, act=act),
            CspLayer(base_channels * 2, base_channels * 2, n=base_depth,
                     depthwise=depthwise, act=act),
        )
        self.dark3 = nn.Sequential(
            Conv(base_channels * 2, base_channels * 4, 3, 2, act=act),
            CspLayer(base_channels * 4, base_channels * 4, n=base_depth * 3,
                     depthwise=depthwise, act=act),
        )
        self.dark4 = nn.Sequential(
            Conv(base_channels * 4, base_channels * 8, 3, 2, act=act),
            CspLayer(base_channels * 8, base_channels * 8, n=base_depth * 3,
                     depthwise=depthwise, act=act),
        )
        self.dark5 = nn.Sequential(
            Conv(base_channels * 8, base_channels * 16, 3, 2, act=act),
            SPPBottleneck(base_channels * 16, base_channels * 16,
                          activation=act),
            CspLayer(base_channels * 16, base_channels * 16, n=base_depth,
                     shortcut=False, depthwise=depthwise, act=act),
        )

    def init_params(self, rng):
        init_children(rng, self.stem, *self.dark2, *self.dark3, *self.dark4,
                      *self.dark5)

    def forward(self, x):
        outputs = {}
        x = self.stem(x)
        outputs["stem"] = x
        for name in ("dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
