"""Checkpoint I/O, the port's counterpart of the JAX package's
`yolox_tpu/utils/checkpoint.py` (the reference's
`yolox/utils/checkpoint.py`).

Checkpoints are upstream `.pth` files, `<name>_ckpt.pth` with a
`best_ckpt.pth` copy: `model` is the upstream state dict (OIHW kernels),
so a checkpoint of either package, or of the reference, loads into the
other with `strict=True`. Beside it the trainer stores `start_epoch`,
`best_ap`, `curr_ap` and `momentum_buf`, the SGD momentum in the JAX
package's layout (nested keys, HWIO kernels), so either package resumes
from the other's file.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import numpy as np
import torch

from yolox_tpu_torch.models.weights import nested_to_flat
from yolox_tpu_torch.utils.logger import logger


def save_checkpoint(state: Dict[str, Any], is_best: bool, save_dir: str,
                    model_name: str = ""):
    """Write `state` (its `model` a state dict) to
    `save_dir/<model_name>_ckpt.pth`, tensors on the CPU; copy it to
    `best_ckpt.pth` when `is_best`."""
    os.makedirs(save_dir, exist_ok=True)
    out = dict(state)
    out["model"] = {k: v.detach().cpu() for k, v in state["model"].items()}
    filename = os.path.join(save_dir, model_name + "_ckpt.pth")
    torch.save(out, filename)
    if is_best:
        shutil.copyfile(filename, os.path.join(save_dir, "best_ckpt.pth"))


def _numpy_globals():
    """What pickled numpy arrays and scalars need (the JAX package stores
    its momentum as numpy arrays, its APs as numpy scalars): their
    reconstructors, ndarray and the dtypes."""
    reconstruct = np.ndarray.__reduce__(np.zeros(1))[0]
    scalar = np.float64(0).__reduce__()[0]
    return [reconstruct, scalar, np.ndarray, np.dtype] + [
        type(np.dtype(t)) for t in (np.float32, np.float64, np.int32,
                                    np.int64, np.uint8, np.bool_)]


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of either package or of the reference, unpickled with
    `weights_only=True` (tensors, containers, scalars and numpy arrays
    and scalars only); `model` is returned as the flat state dict."""
    with torch.serialization.safe_globals(_numpy_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in ckpt:
        ckpt["model"] = {k: torch.as_tensor(v) for k, v in
                         nested_to_flat(ckpt["model"]).items()}
    return ckpt


def load_ckpt(module: torch.nn.Module, ckpt: Dict[str, Any]):
    """Shape-tolerant partial load (`checkpoint.py:9-31`): keys missing
    from the checkpoint or with other shapes keep the module's values.
    Returns `module`."""
    model_sd = module.state_dict()
    load = {}
    for key, model_v in model_sd.items():
        if key not in ckpt:
            logger.warning(f"{key} is not in the ckpt. Please double check "
                           "and see if this is desired.")
            continue
        ckpt_v = ckpt[key]
        if tuple(model_v.shape) != tuple(ckpt_v.shape):
            logger.warning(
                f"Shape of {key} in checkpoint is {tuple(ckpt_v.shape)}, "
                f"while shape of {key} in model is {tuple(model_v.shape)}.")
            continue
        load[key] = ckpt_v
    module.load_state_dict(load, strict=False)
    return module
