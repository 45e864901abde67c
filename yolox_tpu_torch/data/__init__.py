"""Data: the on-device Mosaic/affine/MixUp/HSV/flip augmentation."""

from yolox_tpu_torch.data.device_augment import (
    augment_with_draws,
    device_augment_batch,
    sample_augment_draws,
)

__all__ = ["augment_with_draws", "device_augment_batch",
           "sample_augment_draws"]
