"""Host-side transforms, the port's copy of the JAX package's
`yolox_tpu/data/data_augment.py` (the reference's
`yolox/data/data_augment.py`): HSV jitter, random affine, mirror, the
training transform and the evaluation letterbox. Output images are HWC
float32, as in the JAX package.

Every random draw comes from the explicit numpy Generator (`rng`), in the
JAX package's order, so a seeded sample is the same in both packages. The
image operations are `data/cv2_compat.py`'s: cv2 when it imports, else
numpy versions of cv2's arithmetic.
"""

from __future__ import annotations

import math

import numpy as np

from yolox_tpu_torch.data.cv2_compat import (
    bgr_to_hsv,
    hsv_to_bgr,
    rotation_matrix_2d,
    warp_affine,
)
from yolox_tpu_torch.ops.preproc import preproc

__all__ = [
    "augment_hsv",
    "get_affine_matrix",
    "random_affine",
    "apply_affine_to_bboxes",
    "TrainTransform",
    "ValTransform",
    "preproc",
    "xyxy2cxcywh_np",
    "adjust_box_anns",
]


def xyxy2cxcywh_np(bboxes):
    """In-place numpy xyxy -> cxcywh (`yolox/utils/boxes.py:129-134`)."""
    bboxes[:, 2] = bboxes[:, 2] - bboxes[:, 0]
    bboxes[:, 3] = bboxes[:, 3] - bboxes[:, 1]
    bboxes[:, 0] = bboxes[:, 0] + bboxes[:, 2] * 0.5
    bboxes[:, 1] = bboxes[:, 1] + bboxes[:, 3] * 0.5
    return bboxes


def adjust_box_anns(bbox, scale_ratio, padw, padh, w_max, h_max):
    bbox[:, 0::2] = np.clip(bbox[:, 0::2] * scale_ratio + padw, 0, w_max)
    bbox[:, 1::2] = np.clip(bbox[:, 1::2] * scale_ratio + padh, 0, h_max)
    return bbox


def augment_hsv(img, rng, hgain=5, sgain=30, vgain=30):
    """HSV jitter in place on a BGR uint8 image (`data_augment.py:19-29`)."""
    hsv_augs = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain]
    hsv_augs *= rng.integers(0, 2, 3)
    hsv_augs = hsv_augs.astype(np.int16)
    img_hsv = bgr_to_hsv(img).astype(np.int16)

    img_hsv[..., 0] = (img_hsv[..., 0] + hsv_augs[0]) % 180
    img_hsv[..., 1] = np.clip(img_hsv[..., 1] + hsv_augs[1], 0, 255)
    img_hsv[..., 2] = np.clip(img_hsv[..., 2] + hsv_augs[2], 0, 255)

    img[...] = hsv_to_bgr(img_hsv.astype(img.dtype))


def _aug_param(rng, value, center=0.0):
    if isinstance(value, float):
        return rng.uniform(center - value, center + value)
    elif len(value) == 2:
        return rng.uniform(value[0], value[1])
    raise ValueError(
        "Affine params should be either a sequence of two values or a "
        f"single float. Got {value}")


def get_affine_matrix(rng, target_size, degrees=10, translate=0.1,
                      scales=0.1, shear=10):
    """Rotation+scale+shear+translate matrix (`data_augment.py:44-77`)."""
    twidth, theight = target_size
    angle = _aug_param(rng, degrees)
    scale = _aug_param(rng, scales, center=1.0)
    if scale <= 0.0:
        raise ValueError("Argument scale should be positive")
    R = rotation_matrix_2d(angle, scale)

    M = np.ones([2, 3])
    shear_x = math.tan(_aug_param(rng, shear) * math.pi / 180)
    shear_y = math.tan(_aug_param(rng, shear) * math.pi / 180)
    M[0] = R[0] + shear_y * R[1]
    M[1] = R[1] + shear_x * R[0]
    M[0, 2] = _aug_param(rng, translate) * twidth
    M[1, 2] = _aug_param(rng, translate) * theight
    return M, scale


def apply_affine_to_bboxes(targets, target_size, M):
    num_gts = len(targets)
    twidth, theight = target_size
    corner_points = np.ones((4 * num_gts, 3))
    corner_points[:, :2] = targets[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(
        4 * num_gts, 2)  # x1y1, x2y2, x1y2, x2y1
    corner_points = corner_points @ M.T
    corner_points = corner_points.reshape(num_gts, 8)

    corner_xs = corner_points[:, 0::2]
    corner_ys = corner_points[:, 1::2]
    new_bboxes = np.concatenate(
        (corner_xs.min(1), corner_ys.min(1),
         corner_xs.max(1), corner_ys.max(1))).reshape(4, num_gts).T

    new_bboxes[:, 0::2] = new_bboxes[:, 0::2].clip(0, twidth)
    new_bboxes[:, 1::2] = new_bboxes[:, 1::2].clip(0, theight)
    targets[:, :4] = new_bboxes
    return targets


def random_affine(img, targets=(), rng=None, target_size=(640, 640),
                  degrees=10, translate=0.1, scales=0.1, shear=10):
    rng = rng if rng is not None else np.random.default_rng()
    M, scale = get_affine_matrix(rng, target_size, degrees, translate,
                                 scales, shear)
    img = warp_affine(img, M, target_size, border_value=114)
    if len(targets) > 0:
        targets = apply_affine_to_bboxes(targets, target_size, M)
    return img, targets


def _mirror(image, boxes, rng, prob=0.5):
    _, width, _ = image.shape
    if rng.random() < prob:
        image = image[:, ::-1]
        boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, boxes


class TrainTransform:
    """HSV + flip + letterbox + cxcywh scaling + fixed-size label padding
    (`data_augment.py:159-208`). Output image is HWC float32."""

    def __init__(self, max_labels=50, flip_prob=0.5, hsv_prob=1.0):
        self.max_labels = max_labels
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob

    def __call__(self, image, targets, input_dim, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        boxes = targets[:, :4].copy()
        labels = targets[:, 4].copy()
        if len(boxes) == 0:
            targets = np.zeros((self.max_labels, 5), dtype=np.float32)
            image, r_o = preproc(image, input_dim)
            return image, targets

        image_o = image.copy()
        targets_o = targets.copy()
        boxes_o = targets_o[:, :4]
        labels_o = targets_o[:, 4]
        boxes_o = xyxy2cxcywh_np(boxes_o)

        if rng.random() < self.hsv_prob:
            augment_hsv(image, rng)
        image_t, boxes = _mirror(image, boxes, rng, self.flip_prob)
        image_t, r_ = preproc(image_t, input_dim)
        boxes = xyxy2cxcywh_np(boxes)
        boxes *= r_

        mask_b = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
        boxes_t = boxes[mask_b]
        labels_t = labels[mask_b]

        if len(boxes_t) == 0:
            image_t, r_o = preproc(image_o, input_dim)
            boxes_o *= r_o
            boxes_t = boxes_o
            labels_t = labels_o

        labels_t = np.expand_dims(labels_t, 1)
        targets_t = np.hstack((labels_t, boxes_t))
        padded_labels = np.zeros((self.max_labels, 5))
        padded_labels[range(len(targets_t))[: self.max_labels]] = \
            targets_t[: self.max_labels]
        padded_labels = np.ascontiguousarray(padded_labels, dtype=np.float32)
        return image_t, padded_labels


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
