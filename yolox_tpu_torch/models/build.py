"""Model factory functions, the PyTorch counterpart of the JAX package's
`yolox_tpu/models/build.py` (a working re-design of the reference's
`yolox/models/build.py`).

`create_yolox_model("yolox-s")` returns a ready YoloxModule; the
per-model helpers mirror the reference's torch.hub-style surface. The
upstream checkpoint URL table lives in `models/yolox.py` (`_WEIGHTS_URL`,
`_WEIGHTS_ALIAS`: yolov3 loads `yolox_darknet.pth`).
"""

from __future__ import annotations

import importlib
from typing import Optional

from yolox_tpu_torch.config import YoloxConfig

__all__ = [
    "create_yolox_model",
    "yolox_nano",
    "yolox_tiny",
    "yolox_s",
    "yolox_m",
    "yolox_l",
    "yolox_x",
    "yolov3",
    "yolox_custom",
]

_NAMES = ("yolox-nano", "yolox-tiny", "yolox-s", "yolox-m", "yolox-l",
          "yolox-x", "yolov3")


def _resolve_config(name: str) -> YoloxConfig:
    """A named config, or a `module:ClassName` YoloxConfig subclass."""
    config = YoloxConfig.get_named_config(name)
    if config is not None:
        return config
    if ":" in name:
        module_name, class_name = name.rsplit(":", 1)
        cls = getattr(importlib.import_module(module_name), class_name, None)
        if not (isinstance(cls, type) and issubclass(cls, YoloxConfig)):
            raise ValueError(f"{name} is not a YoloxConfig subclass")
        return cls()
    raise ValueError(f"Unknown model config: {name}")


def create_yolox_model(name: str, pretrained: bool = True,
                       num_classes: int = 80, device=None,
                       exp_path: Optional[str] = None,
                       ckpt_path: Optional[str] = None):
    """Create (and optionally load) a YOLOX model on `device` (cuda unless
    given).

    Args:
        name: one of yolox-nano/tiny/s/m/l/x, yolov3, or "yolox_custom".
        pretrained: load upstream pretrained weights (num_classes must
            be 80).
        num_classes: detection classes.
        device: where the module lives.
        exp_path: for "yolox_custom", a `module:ClassName` config path.
        ckpt_path: for "yolox_custom", optional checkpoint to load.
    """
    from yolox_tpu_torch.models.yolox import YoloxModule

    if name in _NAMES:
        config = YoloxConfig.get_named_config(name)
        config.num_classes = num_classes
        if pretrained and num_classes == 80:
            return YoloxModule.from_pretrained(name, device=device)
        return YoloxModule.from_config(config, device=device)

    if name != "yolox_custom":
        raise ValueError(f'user should use one of {_NAMES} or "yolox_custom"')
    if exp_path is None:
        raise ValueError('for a "yolox_custom" model exp_path must be provided')
    module = YoloxModule.from_config(_resolve_config(exp_path), device=device)
    if ckpt_path:
        from yolox_tpu_torch.utils.checkpoint import load_checkpoint

        module.load_params(load_checkpoint(ckpt_path)["model"])
    return module


def yolox_nano(pretrained=True, num_classes=80, device=None):
    return create_yolox_model("yolox-nano", pretrained, num_classes, device)


def yolox_tiny(pretrained=True, num_classes=80, device=None):
    return create_yolox_model("yolox-tiny", pretrained, num_classes, device)


def yolox_s(pretrained=True, num_classes=80, device=None):
    return create_yolox_model("yolox-s", pretrained, num_classes, device)


def yolox_m(pretrained=True, num_classes=80, device=None):
    return create_yolox_model("yolox-m", pretrained, num_classes, device)


def yolox_l(pretrained=True, num_classes=80, device=None):
    return create_yolox_model("yolox-l", pretrained, num_classes, device)


def yolox_x(pretrained=True, num_classes=80, device=None):
    return create_yolox_model("yolox-x", pretrained, num_classes, device)


def yolov3(pretrained=True, num_classes=80, device=None):
    return create_yolox_model("yolov3", pretrained, num_classes, device)


def yolox_custom(ckpt_path=None, exp_path=None, device=None):
    return create_yolox_model("yolox_custom", ckpt_path=ckpt_path,
                              exp_path=exp_path, device=device)
