"""yolox_tpu_torch: the PyTorch/CUDA port of yolox_tpu for NVIDIA Hopper.

The same public API as the JAX package `yolox_tpu`, which stays the
reference:

    from yolox_tpu_torch import Yolox
    model = Yolox.from_pretrained("yolox_s")      # on cuda
    detections = model(["image.jpg"], threshold=0.5)

The network is a set of NCHW `nn.Module`s with the upstream state-dict
keys; the Focus stem and the NMS suppression run as hand-written CUDA
kernels (`yolox_tpu_torch/csrc/`), built with nvcc on first use. Training
(`yolox_tpu_torch.core.make_train_step`) runs the fused Conv-BN-SiLU
backward of the 1x1 convs as two more such kernels, and the on-device
Mosaic/MixUp augmentation (`yolox_tpu_torch.data.device_augment_batch`,
`core.make_augmented_train_step`) runs its shear passes as a fifth.
Evaluation (`YoloxConfig.get_evaluator` / `YoloxConfig.eval`,
`yolox_tpu_torch.evaluators`) runs COCO and VOC on the module's device.
yolov3 (Darknet-53 + YoloFpn) serves like the CSPDarknet models, and int8
post-training quantization (`YoloxModule.calibrate_int8`, `serve(...,
int8_qtab=...)` or `int8_hbm_qtab=...`, `enable_int8`) runs its convs as
two more hand-written kernels (`csrc/int8_conv.cu`). The `yolox-tpu-torch`
command (`yolox_tpu_torch.cli`) trains, evaluates, runs the demo and
exports a `torch.export` program that carries the serving kernels as
registered operators (`yolox_tpu_torch.ops.library`, registered when the
package is imported).
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
from yolox_tpu_torch.data import device_augment_batch

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
    "device_augment_batch",
]
