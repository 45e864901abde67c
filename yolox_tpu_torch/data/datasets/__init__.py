"""Datasets: COCO and VOC on the cache-capable base, the concatenations,
and the Mosaic/MixUp wrapper."""

from yolox_tpu_torch.data.datasets.coco_classes import COCO_CLASSES
from yolox_tpu_torch.data.datasets.voc_classes import VOC_CLASSES
from yolox_tpu_torch.data.datasets.datasets_wrapper import (
    CacheDataset,
    ConcatDataset,
    Dataset,
    MixConcatDataset,
    cache_read_img,
)
from yolox_tpu_torch.data.datasets.coco import CocoDataset
from yolox_tpu_torch.data.datasets.mosaicdetection import MosaicDetection
from yolox_tpu_torch.data.datasets.voc import VocDetection

__all__ = [
    "COCO_CLASSES",
    "VOC_CLASSES",
    "CacheDataset",
    "ConcatDataset",
    "Dataset",
    "MixConcatDataset",
    "MosaicDetection",
    "cache_read_img",
    "CocoDataset",
    "VocDetection",
]
