"""The YOLOX network as PyTorch modules with the upstream state-dict keys."""

from yolox_tpu_torch.models.blocks import (
    BaseConv,
    Bottleneck,
    CspLayer,
    DWConv,
    Focus,
    SPPBottleneck,
)
from yolox_tpu_torch.models.darknet import CspDarknet
from yolox_tpu_torch.models.pafpn import YoloPafpn
from yolox_tpu_torch.models.head import YoloxHead
from yolox_tpu_torch.models.yolox import Yolox, YoloxModule
from yolox_tpu_torch.models.processor import Detections, YoloxProcessor

__all__ = [
    "BaseConv",
    "Bottleneck",
    "CspLayer",
    "DWConv",
    "Focus",
    "SPPBottleneck",
    "CspDarknet",
    "YoloPafpn",
    "YoloxHead",
    "Yolox",
    "YoloxModule",
    "YoloxProcessor",
    "Detections",
]
