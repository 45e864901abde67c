"""yolox_tpu_torch: the PyTorch/CUDA port of yolox_tpu for NVIDIA Hopper.

The same public API as the JAX package `yolox_tpu`, which stays the
reference:

    from yolox_tpu_torch import Yolox
    model = Yolox.from_pretrained("yolox_s")      # on cuda
    detections = model(["image.jpg"], threshold=0.5)

The network is a set of NCHW `nn.Module`s with the upstream state-dict
keys; the Focus stem and the NMS suppression run as hand-written CUDA
kernels (`yolox_tpu_torch/csrc/`), built with nvcc on first use.
"""

from yolox_tpu_torch.version import __version__

from yolox_tpu_torch.config import (
    YoloxConfig,
    YoloxS,
    YoloxM,
    YoloxL,
    YoloxX,
    YoloxTiny,
    YoloxNano,
    Yolov3,
)
from yolox_tpu_torch.models.yolox import Yolox, YoloxModule
from yolox_tpu_torch.models.processor import Detections, YoloxProcessor

__all__ = [
    "__version__",
    "YoloxConfig",
    "YoloxS",
    "YoloxM",
    "YoloxL",
    "YoloxX",
    "YoloxTiny",
    "YoloxNano",
    "Yolov3",
    "Yolox",
    "YoloxModule",
    "YoloxProcessor",
    "Detections",
]
