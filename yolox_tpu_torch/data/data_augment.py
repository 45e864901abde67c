"""Host-side transforms, the port's copy of the evaluation part of the JAX
package's `yolox_tpu/data/data_augment.py`: `ValTransform`, the letterbox
of `ops/preproc.py`. Output HWC float32, as in the JAX package. The
training transforms come with the host data path (ROADMAP M7); on the
card, training augments with `data/device_augment.py`.
"""

from __future__ import annotations

import numpy as np

from yolox_tpu_torch.ops.preproc import preproc

__all__ = ["ValTransform", "preproc"]


class ValTransform:
    """Letterbox only; optional legacy mode (BGR->RGB, /255, ImageNet norm)
    (upstream `data_augment.py:211-241`). Output HWC float32."""

    def __init__(self, legacy: bool = False):
        self.legacy = legacy

    def __call__(self, img, res, input_size, rng=None):
        img, _ = preproc(img, input_size)
        if self.legacy:
            img = img[:, :, ::-1].copy()  # BGR -> RGB (HWC layout)
            img /= 255.0
            img -= np.array([0.485, 0.456, 0.406]).reshape(1, 1, 3)
            img /= np.array([0.229, 0.224, 0.225]).reshape(1, 1, 3)
        return img, np.zeros((1, 5))
