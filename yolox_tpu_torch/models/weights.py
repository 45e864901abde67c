"""`.pth` checkpoints and the JAX package's parameter pytree.

The port's modules carry the upstream state-dict keys
(`backbone.backbone.dark2.0.conv.weight`, `head.cls_preds.0.bias`, ...), so
an upstream `.pth` loads with `load_state_dict(strict=True)`. The JAX
package keeps the same keys as a nested dict with HWIO conv kernels;
`state_dict_from_jax` and `state_dict_to_jax` convert between the two
without importing either JAX or the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

_STAT_KEYS = ("num_batches_tracked",)


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


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (nested or flat, numpy or any
    array that `np.asarray` takes) -> the port's state dict: conv kernels
    HWIO -> OIHW float32, `num_batches_tracked` -> int64 scalars."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in nested_to_flat(params).items():
        arr = np.asarray(value)
        if key.endswith(_STAT_KEYS):
            arr = arr.astype(np.int64).reshape(())
        else:
            arr = arr.astype(np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def state_dict_to_jax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of `state_dict_from_jax`: a nested numpy pytree in the JAX
    package's layout (HWIO kernels, int32 `num_batches_tracked`)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            if value.is_floating_point():
                value = value.float()
            value = value.numpy()
        arr = np.asarray(value)
        if key.endswith(_STAT_KEYS):
            arr = arr.astype(np.int32).reshape(())
        else:
            arr = arr.astype(np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
        flat[key] = arr
    return flat_to_nested(flat)


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
