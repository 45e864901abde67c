"""The operations and bytes the yardstick divides by, counted on the
benchmark's own reference network of the configuration's architecture
(`perfbench/archs/<arch>.py::reference`), so that no change to the
program moves them.

`conv_flops` runs the reference forward on meta tensors under a
`TorchDispatchMode` and sums, over every `aten.convolution`, 2 * output
elements * kh * kw * Cin / groups (the rule of the program's old census,
`scripts/torch_serve_traffic_model.py::ConvCensus`), the stem
included: a multiply and an add per tap. BatchNorm, activations, pooling,
the decode and the NMS are left out, as in the published GFLOPs.

`stem_bytes` is kernel K1's least traffic: the uint8 image read once, the
stem map written once in the module's dtype, and the folded weights with
the BN scale and bias read once in float32.
"""

from __future__ import annotations

import functools
import json
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench import cells


class _ConvCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            w = args[1]
            self.flops += 2 * out.numel() * math.prod(w.shape[1:])
        return out


@functools.lru_cache(maxsize=None)
def conv_flops(config_json: str) -> int:
    """Forward conv FLOPs of one image at the input size of the
    configuration `config_json` (its JSON text: the whole configuration,
    its `arch` with it, is the cache's key)."""
    config = json.loads(config_json)
    net = cells.arch(config).reference(config, device="meta")
    x = torch.empty((1, 3, *config["input_size"]), device="meta")
    count = _ConvCount()
    with torch.no_grad(), count:
        net.head.levels(net.backbone(x))
    return count.flops


def config_flops(config: dict) -> int:
    """Forward conv FLOPs of one image at the configuration's input
    size."""
    return conv_flops(json.dumps(config, sort_keys=True))


def stem_bytes(config: dict, batch: int, itemsize: int = 2) -> int:
    """K1's least bytes for one call on a uint8 batch."""
    h, w = config["input_size"]
    c = int(config["width"] * 64)
    image = batch * h * w * 3
    out = batch * c * (h // 2) * (w // 2) * itemsize
    weights = (c * 3 * 6 * 6 + 2 * c) * 4
    return image + out + weights


def stem_flops(config: dict, batch: int) -> int:
    h, w = config["input_size"]
    c = int(config["width"] * 64)
    return 2 * batch * c * (h // 2) * (w // 2) * 3 * 6 * 6
