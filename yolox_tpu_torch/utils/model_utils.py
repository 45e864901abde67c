"""Model utilities, the port's counterpart of the JAX package's
`yolox_tpu/utils/model_utils.py` (the reference's
`yolox/utils/model_utils.py`).

`get_model_info` counts parameters and the multiply-adds of one forward at
`tsize` (torch's `FlopCounterMode`, the thop convention the reference
reports); `fuse_conv_and_bn` / `fuse_model` fold eval BatchNorm into the
conv kernels with the JAX package's `fuse_model_params` arithmetic;
`freeze_mask` marks the parameters under a prefix; `adjust_status` sets a
module's train/eval status for a block and restores every submodule's
status after it.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Tuple

import torch

from yolox_tpu_torch.models.blocks import BN_EPS, BaseConv


def count_params(module: torch.nn.Module) -> int:
    """Trainable parameter count (BN running statistics excluded)."""
    return int(sum(p.numel() for p in module.parameters()))


def get_model_info(module: torch.nn.Module, tsize: Tuple[int, int]) -> str:
    """'Params: %.2fM, Gflops: %.2f' for a (1, h, w, 3) eval forward; the
    count runs on a float32 CPU copy, where every operation is a torch
    operation the counter sees."""
    from torch.utils.flop_counter import FlopCounterMode

    n_params = count_params(module) / 1e6
    probe = copy.deepcopy(module).cpu().float().eval()
    with FlopCounterMode(display=False) as counter:
        probe(torch.zeros(1, tsize[0], tsize[1], 3))
    # multiply-adds, the number thop (and the reference) reports
    return f"Params: {n_params:.2f}M, Gflops: " \
        f"{counter.get_total_flops() / 2e9:.2f}"


@torch.no_grad()
def fuse_conv_and_bn(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    """Fold `bn`'s eval statistics into `conv` in place: the kernel scaled
    by gamma / sqrt(var + eps) (in float64, stored in the kernel's dtype),
    and `bn` turned into the identity plus the folded bias (gamma 1, beta
    beta - mean * scale, mean 0, var 1 - eps)."""
    gamma = bn.weight.double()
    scale = gamma / torch.sqrt(bn.running_var.double() + BN_EPS)
    bias = bn.bias.double() - bn.running_mean.double() * scale
    conv.weight.copy_(conv.weight.double() * scale[:, None, None, None])
    bn.weight.fill_(1.0)
    bn.bias.copy_(bias)
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - BN_EPS)
    return conv, bn


def fuse_model(module: torch.nn.Module) -> torch.nn.Module:
    """Fold the BatchNorm of every BaseConv into its conv (eval use);
    the state-dict keys stay, so the module still loads and saves
    `.pth` files. Returns `module`."""
    for m in module.modules():
        if isinstance(m, BaseConv):
            fuse_conv_and_bn(m.conv, m.bn)
    return module


def freeze_mask(module: torch.nn.Module, prefix: str = "") -> Dict[str, float]:
    """{parameter name: 0.0 under `prefix` (frozen), else 1.0}."""
    return {name: 0.0 if name.startswith(prefix) else 1.0
            for name, _ in module.named_parameters()}


@contextlib.contextmanager
def adjust_status(module: torch.nn.Module, training: bool = False):
    """Put `module` in train (`training`) or eval mode for the block, then
    restore each submodule's own status (`model_utils.py:157-184`)."""
    status = {m: m.training for m in module.modules()}
    module.train(training)
    try:
        yield module
    finally:
        for m, was_training in status.items():
            m.training = was_training
