"""Model EMA, the PyTorch counterpart of the JAX package's
`yolox_tpu/utils/ema.py` (reference `yolox/utils/ema.py:20-58`).

A float32 eval-mode copy of the model whose every float entry of the state
dict (weights and BatchNorm statistics) is a moving average; integer
entries (`num_batches_tracked`) are copied. The decay ramps as
d = decay * (1 - exp(-updates / 2000)), computed in float32 as in JAX.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def ema_decay(updates: int, decay: float = 0.9998) -> float:
    """d for the post-increment update count, in float32 arithmetic."""
    u = np.float32(updates)
    return float(np.float32(decay)
                 * (np.float32(1.0) - np.exp(-u / np.float32(2000.0))))


class ModelEMA:
    def __init__(self, model: torch.nn.Module, updates: int = 0):
        self.ema = copy.deepcopy(model).float().eval()
        self.ema.requires_grad_(False)
        self.updates = updates

    @torch.no_grad()
    def update(self, model: torch.nn.Module, decay: float = 0.9998) -> None:
        self.updates += 1
        d = ema_decay(self.updates, decay)
        msd = model.state_dict()
        for k, v in self.ema.state_dict().items():
            if v.is_floating_point():
                v.mul_(d).add_((1.0 - d) * msd[k].float())
            else:
                v.copy_(msd[k])
