"""CSPDarknet and legacy Darknet-21/53 backbones (NCHW), the PyTorch
counterparts of the JAX package's `yolox_tpu/models/darknet.py`: the same
topologies and state-dict keys. Both take the NHWC image: CspDarknet's
Focus stem runs as the stem kernel K1, Darknet's 3x3 BaseConv stem reads
it as a channels_last NCHW view; every later stage is NCHW.
"""

from __future__ import annotations

import torch.nn as nn

from yolox_tpu_torch.models.blocks import (
    BaseConv,
    CspLayer,
    DWConv,
    Focus,
    ResLayer,
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


class Darknet(nn.Module):
    """Legacy Darknet-21/53 backbone (`darknet.py:8-92`), lrelu
    activations; dark5 carries the SPP block."""

    depth2blocks = {21: [1, 2, 2, 1], 53: [2, 8, 8, 4]}

    def __init__(self, depth, in_channels=3, stem_out_channels=32,
                 out_features=("dark3", "dark4", "dark5")):
        super().__init__()
        if not out_features:
            raise ValueError("please provide output features of Darknet")
        self.out_features = tuple(out_features)
        self.stem = nn.Sequential(
            BaseConv(in_channels, stem_out_channels, ksize=3, stride=1,
                     act="lrelu"),
            *self._group_layer(stem_out_channels, num_blocks=1, stride=2))
        in_ch = stem_out_channels * 2
        num_blocks = Darknet.depth2blocks[depth]
        self.dark2 = nn.Sequential(*self._group_layer(in_ch, num_blocks[0], 2))
        in_ch *= 2
        self.dark3 = nn.Sequential(*self._group_layer(in_ch, num_blocks[1], 2))
        in_ch *= 2
        self.dark4 = nn.Sequential(*self._group_layer(in_ch, num_blocks[2], 2))
        in_ch *= 2
        self.dark5 = nn.Sequential(
            *self._group_layer(in_ch, num_blocks[3], 2),
            *self._spp_block([in_ch, in_ch * 2], in_ch * 2))

    @staticmethod
    def _group_layer(in_channels: int, num_blocks: int, stride: int = 1):
        return [BaseConv(in_channels, in_channels * 2, ksize=3, stride=stride,
                         act="lrelu"),
                *[ResLayer(in_channels * 2) for _ in range(num_blocks)]]

    @staticmethod
    def _spp_block(filters_list, in_filters):
        return [
            BaseConv(in_filters, filters_list[0], 1, stride=1, act="lrelu"),
            BaseConv(filters_list[0], filters_list[1], 3, stride=1,
                     act="lrelu"),
            SPPBottleneck(filters_list[1], filters_list[0],
                          activation="lrelu"),
            BaseConv(filters_list[0], filters_list[1], 3, stride=1,
                     act="lrelu"),
            BaseConv(filters_list[1], filters_list[0], 1, stride=1,
                     act="lrelu"),
        ]

    def init_params(self, rng):
        init_children(rng, *self.stem, *self.dark2, *self.dark3, *self.dark4,
                      *self.dark5)

    def forward(self, x):
        """x: the (B, H, W, 3) image. Returns the requested NCHW maps."""
        outputs = {}
        x = self.stem(x.permute(0, 3, 1, 2))
        outputs["stem"] = x
        for name in ("dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
