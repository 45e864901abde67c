"""`.pth` checkpoints and the JAX package's parameter pytree.

The port's modules carry the upstream state-dict keys
(`backbone.backbone.dark2.0.conv.weight`, `head.cls_preds.0.bias`, ...), so
an upstream `.pth` loads with `load_state_dict(strict=True)`. The JAX
package keeps the same keys as a nested dict with HWIO conv kernels;
`state_dict_from_jax` and `state_dict_to_jax` convert between the two,
and `train_state_from_jax` / `train_state_to_jax` carry a whole training
state (parameters, BN statistics, SGD momentum, EMA, counters), all
without importing either JAX or the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

_STAT_KEYS = ("num_batches_tracked",)
# BatchNorm statistics: the JAX train state keeps them apart from the
# trainable leaves (`split_train_state`)
STAT_LEAF_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def flat_to_nested(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def nested_to_flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(nested_to_flat(v, key))
        else:
            flat[key] = v
    return flat


def _float_dtype(arr):
    return np.float64 if arr.dtype == np.float64 else np.float32


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (nested or flat, numpy or any
    array that `np.asarray` takes) -> the port's state dict: conv kernels
    HWIO -> OIHW, floats float32 (float64 stays float64),
    `num_batches_tracked` -> int64 scalars."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in nested_to_flat(params).items():
        arr = np.asarray(value)
        if key.endswith(_STAT_KEYS):
            arr = arr.astype(np.int64).reshape(())
        else:
            arr = arr.astype(_float_dtype(arr))
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def state_dict_to_jax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of `state_dict_from_jax`: a nested numpy pytree in the JAX
    package's layout (HWIO kernels, float32 or float64 floats, int32
    `num_batches_tracked`)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            if value.is_floating_point() and value.dtype != torch.float64:
                value = value.float()
            value = value.numpy()
        arr = np.asarray(value)
        if key.endswith(_STAT_KEYS):
            arr = arr.astype(np.int32).reshape(())
        else:
            arr = arr.astype(_float_dtype(arr))
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
        flat[key] = arr
    return flat_to_nested(flat)


def _partition(tree: Dict[str, Any], pick_stats: bool) -> Dict[str, Any]:
    flat = nested_to_flat(tree)
    return flat_to_nested({k: v for k, v in flat.items()
                           if (k.rsplit(".", 1)[-1] in STAT_LEAF_KEYS)
                           == pick_stats})


def split_train_state(params: Dict[str, Any]):
    """A nested parameter tree -> (trainable, stats), the JAX package's
    split (`yolox_tpu/models/weights.py:138`)."""
    return _partition(params, False), _partition(params, True)


def merge_params(trainable: Dict[str, Any], stats: Dict[str, Any]):
    """Inverse of `split_train_state`."""
    return flat_to_nested({**nested_to_flat(trainable),
                           **nested_to_flat(stats)})


def weight_decay_applies(name: str, param: torch.Tensor) -> bool:
    """The reference's optimizer groups (`config.py:307-331`): conv
    weights (4-D) decay; BN gammas and all biases do not."""
    return name.rsplit(".", 1)[-1] == "weight" and param.dim() == 4


def train_state_from_jax(jstate: Dict[str, Any], state) -> None:
    """Load the JAX package's train state (`init_train_state`'s dict of
    numpy trees: params, stats, momentum, step and, with EMA, ema and
    ema_updates) into the port's `TrainState` in place: the module's
    parameters and BN statistics, the SGD momentum buffers, the EMA model
    and the counters. A zero momentum buffer is the same as none: torch's
    first step then sets the buffer to the gradient, as JAX's does."""
    module = state.module
    sd = state_dict_from_jax(merge_params(jstate["params"], jstate["stats"]))
    module.load_state_dict(sd, strict=True)
    momentum = state_dict_from_jax(jstate["momentum"])
    for name, p in module.named_parameters():
        state.optimizer.state[p]["momentum_buffer"] = \
            momentum[name].to(p.device, p.dtype).clone()
    state.step = int(np.asarray(jstate["step"]))
    if state.ema is not None:
        state.ema.ema.load_state_dict(state_dict_from_jax(jstate["ema"]),
                                      strict=True)
        state.ema.updates = int(np.asarray(jstate["ema_updates"]))


def train_state_to_jax(state) -> Dict[str, Any]:
    """The port's `TrainState` -> the JAX package's train-state layout as
    numpy trees (the inverse of `train_state_from_jax`)."""
    module = state.module
    trainable, stats = split_train_state(state_dict_to_jax(
        module.state_dict()))
    buffers = {}
    for name, p in module.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        buffers[name] = torch.zeros_like(p) if buf is None else buf
    out = {"params": trainable, "stats": stats,
           "momentum": state_dict_to_jax(buffers),
           "step": np.int32(state.step)}
    if state.ema is not None:
        out["ema"] = state_dict_to_jax(state.ema.ema.state_dict())
        out["ema_updates"] = np.int32(state.ema.updates)
    return out


def load_pth_state_dict(path: str | os.PathLike) -> Dict[str, torch.Tensor]:
    """Read a `.pth` checkpoint: the `{'model': state_dict, ...}` training
    layout or a bare state dict. Only tensors and plain containers are
    unpickled (`weights_only=True`)."""
    weights = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(weights, dict) and "model" in weights:
        weights = weights["model"]
    return dict(weights)


def save_pth_state_dict(state_dict: Dict[str, torch.Tensor],
                        path: str | os.PathLike) -> None:
    """Save as an upstream-compatible `.pth` (`{'model': state_dict}`)."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"model": sd}, str(path))
