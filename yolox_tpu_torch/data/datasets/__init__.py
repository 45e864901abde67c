"""Datasets: COCO and VOC for evaluation, on the cache-capable base."""

from yolox_tpu_torch.data.datasets.coco_classes import COCO_CLASSES
from yolox_tpu_torch.data.datasets.voc_classes import VOC_CLASSES
from yolox_tpu_torch.data.datasets.datasets_wrapper import (
    CacheDataset,
    Dataset,
    cache_read_img,
)
from yolox_tpu_torch.data.datasets.coco import CocoDataset
from yolox_tpu_torch.data.datasets.voc import VocDetection

__all__ = [
    "COCO_CLASSES",
    "VOC_CLASSES",
    "CacheDataset",
    "Dataset",
    "cache_read_img",
    "CocoDataset",
    "VocDetection",
]
