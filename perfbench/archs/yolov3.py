"""YOLOX-Darknet53 (`yolov3`): Darknet-53 with a full-resolution pixel
conv and an SPP block in dark5, the YOLOv3 FPN, and the decoupled YOLOX
head at `in_channels` (128, 256, 512), LeakyReLU 0.1 throughout. It has
no depth or width multiplier.

What the harness knows of an architecture (`perfbench/archs/yolox.py`'s
docstring): `reference`, `program`, `STEM`, `RESIDUAL`, `small`.
"""

from __future__ import annotations

import re

import torch

from perfbench.reference import yolov3 as ref_yolov3

# no key: the 3x3 conv on the pixels (`stem.0`) is drawn as every other
# k x k conv, at CONV_GAIN with zero-sum taps. It is a plain conv whose
# bf16 output is rounded before eval BN subtracts its mean; a stem draw
# (non-zero-sum taps on raw 0..255 pixels) makes that output mostly the
# frame's mean level, and the seeded network, LReLU and BN down ~60 convs,
# amplifies its rounding: on an H100 the bf16 program's score gap to the
# float32 reference was 0.17-0.21 with it, 0.04 without.
STEM = re.compile(r"(?!)")
# the second conv of a ResLayer (`<group>.<i>.layer2`): 23 of them
RESIDUAL = re.compile(r"\.layer2\.conv\.weight$")


def reference(config: dict, quant=ref_yolov3.identity, device="cpu"):
    return ref_yolov3.build(config, quant=quant, device=device)


def program(config: dict, state: dict, device, dtype):
    """The port's network with `state` loaded, in eval mode, in `dtype`;
    and its `YoloxConfig`."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.models import YoloFpn, YoloxHead

    cfg = YoloxConfig.get_named_config(config["registry_name"])
    cfg.num_classes = config["num_classes"]
    cfg.test_size = tuple(config["input_size"])
    with torch.device(device):
        module = YoloxModule(
            YoloFpn(),
            YoloxHead(cfg.num_classes, cfg.width, in_channels=(128, 256, 512),
                      act=config["act"]), config=cfg)
    module.cast_params(dtype)
    module.load_params(state)
    return module, cfg


def small(config: dict, size: int) -> dict:
    """The configuration at `size` px: Darknet-53 has no width multiplier,
    so only the input is cut."""
    return dict(config, input_size=[size, size])
