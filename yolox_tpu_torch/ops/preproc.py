"""Letterbox preprocessing, numerically identical to the JAX package's
`yolox_tpu/ops/preproc.py` (and the reference `preproc`):

  r = min(target_h / h, target_w / w)
  cv2 INTER_LINEAR resize to (round-down w*r, h*r), cast uint8,
  paste top-left into a 114-filled canvas; no normalization; HWC out.

cv2 (or Pillow as a fallback) is imported only when an image has to be
resized: a frame already at the target size is pasted as it is, which is
exact because an identity-scale INTER_LINEAR resize returns its input.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR)
    # Pillow's BILINEAR can differ from cv2 by one grey level in rare pixels
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size_wh, Image.BILINEAR))


def letterbox_ratio(image_hw, target_hw) -> float:
    """The letterbox scale r = min(th/h, tw/w); every consumer that inverts
    the letterbox uses this one formula."""
    return min(target_hw[0] / image_hw[0], target_hw[1] / image_hw[1])


def preproc(img: np.ndarray, input_size, swap=None, dtype=np.float32):
    """Letterbox an HWC uint8 image to `input_size` (h, w).

    Returns (padded image, ratio). HWC unless `swap` is given (e.g.
    (2, 0, 1) for CHW). `dtype=np.uint8` keeps the pixels as bytes (the
    values are the same), a quarter of the float32 copy to the device.
    """
    if len(img.shape) == 3:
        padded_img = np.ones((input_size[0], input_size[1], 3),
                             dtype=np.uint8) * 114
    else:
        padded_img = np.ones(input_size, dtype=np.uint8) * 114

    r = letterbox_ratio(img.shape[:2], input_size)
    size_wh = (int(img.shape[1] * r), int(img.shape[0] * r))
    if size_wh == (img.shape[1], img.shape[0]):
        resized_img = img
    else:
        resized_img = _resize_linear(img, size_wh)
    padded_img[: size_wh[1], : size_wh[0]] = resized_img.astype(np.uint8)

    if swap is not None:
        padded_img = padded_img.transpose(swap)
    return np.ascontiguousarray(padded_img, dtype=dtype), r
