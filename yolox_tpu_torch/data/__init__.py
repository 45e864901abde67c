"""Data: the on-device Mosaic/affine/MixUp/HSV/flip augmentation, and the
evaluation datasets, transform, sampler and loader."""

from yolox_tpu_torch.data.data_augment import ValTransform
from yolox_tpu_torch.data.dataloading import (
    collate,
    eval_loader,
    get_yolox_datadir,
)
from yolox_tpu_torch.data.datasets import (
    COCO_CLASSES,
    VOC_CLASSES,
    CacheDataset,
    CocoDataset,
    Dataset,
    VocDetection,
)
from yolox_tpu_torch.data.device_augment import (
    augment_with_draws,
    device_augment_batch,
    sample_augment_draws,
)
from yolox_tpu_torch.data.samplers import SequentialBatchSampler

__all__ = ["augment_with_draws", "device_augment_batch",
           "sample_augment_draws", "ValTransform", "collate", "eval_loader",
           "get_yolox_datadir", "COCO_CLASSES", "VOC_CLASSES",
           "CacheDataset", "CocoDataset", "Dataset", "VocDetection",
           "SequentialBatchSampler"]
