"""The YOLOX network as PyTorch modules with the upstream state-dict keys."""

from yolox_tpu_torch.models.blocks import (
    BaseConv,
    Bottleneck,
    CspLayer,
    DWConv,
    Focus,
    ResLayer,
    SPPBottleneck,
)
from yolox_tpu_torch.models.darknet import CspDarknet, Darknet
from yolox_tpu_torch.models.pafpn import YoloPafpn
from yolox_tpu_torch.models.yolo_fpn import YoloFpn
from yolox_tpu_torch.models.head import YoloxHead
from yolox_tpu_torch.models.losses import iou_loss
from yolox_tpu_torch.models.build import (
    create_yolox_model,
    yolov3,
    yolox_custom,
    yolox_l,
    yolox_m,
    yolox_nano,
    yolox_s,
    yolox_tiny,
    yolox_x,
)
from yolox_tpu_torch.models.yolox import Yolox, YoloxModule
from yolox_tpu_torch.models.processor import Detections, YoloxProcessor

__all__ = [
    "BaseConv",
    "Bottleneck",
    "CspLayer",
    "DWConv",
    "Focus",
    "ResLayer",
    "SPPBottleneck",
    "CspDarknet",
    "Darknet",
    "YoloPafpn",
    "YoloFpn",
    "YoloxHead",
    "iou_loss",
    "create_yolox_model",
    "yolov3",
    "yolox_custom",
    "yolox_l",
    "yolox_m",
    "yolox_nano",
    "yolox_s",
    "yolox_tiny",
    "yolox_x",
    "Yolox",
    "YoloxModule",
    "YoloxProcessor",
    "Detections",
]
