"""Data: the host training pipeline (Mosaic/MixUp, transforms, samplers,
loader, device prefetcher), the on-device Mosaic/affine/MixUp/HSV/flip
augmentation and its tile dataset, and the evaluation datasets, transform,
sampler and loader."""

from yolox_tpu_torch.data.data_augment import TrainTransform, ValTransform
from yolox_tpu_torch.data.dataloading import (
    DataLoader,
    DevicePrefetcher,
    collate,
    eval_loader,
    get_yolox_datadir,
)
from yolox_tpu_torch.data.datasets import (
    COCO_CLASSES,
    VOC_CLASSES,
    CacheDataset,
    CocoDataset,
    ConcatDataset,
    Dataset,
    MixConcatDataset,
    MosaicDetection,
    VocDetection,
)
from yolox_tpu_torch.data.device_augment import (
    TileDataset,
    augment_with_draws,
    device_augment_batch,
    sample_augment_draws,
)
from yolox_tpu_torch.data.samplers import (
    InfiniteSampler,
    SequentialBatchSampler,
    YoloBatchSampler,
)

__all__ = ["augment_with_draws", "device_augment_batch",
           "sample_augment_draws", "TileDataset", "TrainTransform",
           "ValTransform", "DataLoader", "DevicePrefetcher", "collate",
           "eval_loader", "get_yolox_datadir", "COCO_CLASSES", "VOC_CLASSES",
           "CacheDataset", "CocoDataset", "ConcatDataset", "Dataset",
           "MixConcatDataset", "MosaicDetection", "VocDetection",
           "InfiniteSampler", "SequentialBatchSampler", "YoloBatchSampler"]
