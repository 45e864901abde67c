"""SGD with the reference's three parameter groups.

The PyTorch counterpart of the JAX package's `yolox_tpu/core/optimizer.py`,
which reproduces `torch.optim.SGD(momentum=0.9, nesterov=True)` with the
groups of the reference (`yolox/config.py:307-331`): BN
gammas without weight decay, conv weights with it, biases without it.
Here it is `torch.optim.SGD` itself:

    g = g + wd * p
    buf = mu * buf + g          (buf starts as g on the first step)
    g = g + mu * buf
    p = p - lr * g
"""

from __future__ import annotations

import torch

from yolox_tpu_torch.models.weights import weight_decay_applies

GROUPS = ("bn_weights", "decay", "biases")


def param_groups(module: torch.nn.Module, weight_decay: float):
    """The three groups, in the reference's order, each tagged by `name`."""
    groups = {name: [] for name in GROUPS}
    for name, p in module.named_parameters():
        if weight_decay_applies(name, p):
            groups["decay"].append(p)
        elif name.endswith("bias"):
            groups["biases"].append(p)
        else:
            groups["bn_weights"].append(p)
    return [{"params": groups[g], "name": g,
             "weight_decay": weight_decay if g == "decay" else 0.0}
            for g in GROUPS]


def build_optimizer(module: torch.nn.Module, *, lr: float,
                    momentum: float = 0.9,
                    weight_decay: float = 5e-4) -> torch.optim.SGD:
    """Nesterov SGD over `module`'s parameters in the three groups."""
    return torch.optim.SGD(param_groups(module, weight_decay), lr=lr,
                           momentum=momentum, nesterov=True)


def set_hyperparams(optimizer: torch.optim.SGD, *, lr: float, momentum: float,
                    weight_decay: float) -> None:
    """Per-step values: the LR schedule's lr in every group, the weight
    decay in the conv-weight group only."""
    for g in optimizer.param_groups:
        g["lr"] = float(lr)
        g["momentum"] = momentum
        g["weight_decay"] = weight_decay if g["name"] == "decay" else 0.0
