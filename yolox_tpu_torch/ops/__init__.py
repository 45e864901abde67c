"""Tensor functions and the hand-written CUDA kernels of the PyTorch port.

The package exports the JAX package's nine public names of
`yolox_tpu/ops/__init__.py`; the three of `ops/nms.py` resolve on first
use, since `ops/nms.py` imports `models/`, whose blocks import this
package. Importing it registers the serving kernels as operators
(`ops/library.py`), which exported programs call."""

from yolox_tpu_torch.ops import library  # noqa: F401
from yolox_tpu_torch.ops.boxes import (
    bboxes_iou,
    cxcywh2xyxy,
    pairwise_iou_xyxy,
    xyxy2cxcywh,
    xyxy2xywh,
)
from yolox_tpu_torch.ops.preproc import preproc

_NMS_NAMES = ("batched_nms_fixed", "nms_fixed", "postprocess_device")

__all__ = [
    "bboxes_iou",
    "cxcywh2xyxy",
    "pairwise_iou_xyxy",
    "xyxy2cxcywh",
    "xyxy2xywh",
    "batched_nms_fixed",
    "nms_fixed",
    "postprocess_device",
    "preproc",
]


def __getattr__(name):
    if name in _NMS_NAMES:
        from yolox_tpu_torch.ops import nms

        return getattr(nms, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
