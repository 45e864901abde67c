"""YOLOX: CSPDarknet with a Focus stem, YOLOPAFPN and the decoupled head,
SiLU, at a configuration's depth and width (yolox-nano to -x).

What the harness knows of an architecture, looked up by a configuration's
`"arch"` (`perfbench/cells.py::arch`):
  reference   the plain float32 network (`perfbench/reference/yolox.py`)
  program     the port's network, built through its public API
  STEM        the weight keys that read pixel values 0..255: they keep
              their draw at `weights.STEM_GAIN`, with no zero-sum taps
  RESIDUAL    the second conv of each residual block, drawn at the
              configuration's `init.residual_gain`
  small       the configuration as the CPU tests cut it
"""

from __future__ import annotations

import re

import torch

from perfbench.reference import yolox as ref_yolox

# the Focus conv, its BN with it
STEM = re.compile(r"^backbone\.backbone\.stem\.")
# the second conv of a CSP bottleneck (`<csp>.m.<i>.conv2`)
RESIDUAL = re.compile(r"\.m\.\d+\.conv2\.conv\.weight$")


def reference(config: dict, quant=ref_yolox.identity, device="cpu"):
    return ref_yolox.build(config, quant=quant, device=device)


def program(config: dict, state: dict, device, dtype):
    """The port's network at the configuration's sizes with `state`
    loaded, in eval mode, in `dtype`; and its `YoloxConfig`."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.models import YoloPafpn, YoloxHead

    cfg = YoloxConfig.get_named_config(config["registry_name"])
    cfg.depth, cfg.width = config["depth"], config["width"]
    cfg.num_classes = config["num_classes"]
    cfg.test_size = tuple(config["input_size"])
    with torch.device(device):
        module = YoloxModule(
            YoloPafpn(cfg.depth, cfg.width, depthwise=False, act="silu"),
            YoloxHead(cfg.num_classes, cfg.width, act="silu"), config=cfg)
    module.cast_params(dtype)
    module.load_params(state)
    return module, cfg


def small(config: dict, size: int) -> dict:
    """The configuration at width 0.125 and `size` px."""
    return dict(config, width=0.125, input_size=[size, size])
