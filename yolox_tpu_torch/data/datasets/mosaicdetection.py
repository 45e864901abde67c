"""Mosaic + MixUp augmentation on the host, the port's copy of the JAX
package's `yolox_tpu/data/datasets/mosaicdetection.py` (the reference's
`yolox/data/datasets/mosaicdetection.py`): a 2x-canvas 4-image mosaic
around a random centre, a random affine (rotation, scale, shear,
translation), MixUp with a random annotated partner, then the training
transform.

The paste geometry of the four quadrants comes from one branch-free
formula (`mosaic_geometry`), and the label transform is one gather /
scale / shift over the concatenated boxes. Every draw comes from the
per-sample Generator that `Dataset.mosaic_getitem` installs, in the JAX
package's order, so a sample is the same for any worker count and in both
packages. The image operations are `data/cv2_compat.py`'s.
"""

from __future__ import annotations

import numpy as np

from yolox_tpu_torch.data.cv2_compat import resize_linear
from yolox_tpu_torch.data.data_augment import adjust_box_anns, random_affine
from yolox_tpu_torch.data.datasets.datasets_wrapper import Dataset

_PAD = 114  # canvas fill, matching the canonical letterbox


def mosaic_geometry(tile_hw, xc, yc, out_h, out_w):
    """Paste rectangles for the 4 quadrant tiles of a 2x mosaic canvas.

    Each tile is anchored at the mosaic center (xc, yc) by the corner that
    touches it (tile 0 grows up-left, 1 up-right, 2 down-left, 3
    down-right) and is cropped to its quadrant and to the canvas bounds.

    tile_hw: (4, 2) (h, w) of the pre-resized tiles. Returns `paste` (4, 4)
    int64 [x1, y1, x2, y2] in canvas coordinates and `shift` (4, 2) int64
    [ox, oy] with canvas[y, x] = tile[y - oy, x - ox]; tile-space boxes map
    to the canvas by adding (ox, oy). The quadrant semantics of the
    reference's `get_mosaic_coordinate` (mosaicdetection.py:14-32).
    """
    h = np.asarray(tile_hw[:, 0], np.int64)
    w = np.asarray(tile_hw[:, 1], np.int64)
    grows_right = np.array([False, True, False, True])
    grows_down = np.array([False, False, True, True])

    # content origin: right/down tiles put tile (0,0) at the center; the
    # others put their far corner there, so the origin sits at center-size
    ox = np.where(grows_right, xc, xc - w)
    oy = np.where(grows_down, yc, yc - h)
    x1 = np.maximum(ox, 0)
    y1 = np.maximum(oy, 0)
    x2 = np.minimum(ox + w, 2 * out_w) * grows_right + xc * ~grows_right
    y2 = np.minimum(oy + h, 2 * out_h) * grows_down + yc * ~grows_down

    paste = np.stack([x1, y1, x2, y2], axis=1)
    shift = np.stack([ox, oy], axis=1)
    return paste, shift


class MosaicDetection(Dataset):
    def __init__(self, dataset, img_size, mosaic=True, preproc=None,
                 degrees=10.0, translate=0.1, mosaic_scale=(0.5, 1.5),
                 mixup_scale=(0.5, 1.5), shear=2.0, enable_mixup=True,
                 mosaic_prob=1.0, mixup_prob=1.0, *args):
        super().__init__(img_size, mosaic=mosaic)
        self._dataset = dataset
        self.preproc = preproc
        self.degrees = degrees
        self.translate = translate
        self.scale = mosaic_scale
        self.shear = shear
        self.mixup_scale = mixup_scale
        self.enable_mosaic = mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob

    def __len__(self):
        return len(self._dataset)

    @Dataset.mosaic_getitem
    def __getitem__(self, idx):
        rng = self.rng
        if not (self.enable_mosaic and rng.random() < self.mosaic_prob):
            self._dataset._input_dim = self.input_dim
            img, label, img_info, img_id = self._dataset.pull_item(idx)
            img, label = self.preproc(img, label, self.input_dim, rng=rng)
            return img, label, img_info, img_id

        out_h, out_w = self.input_dim[0], self.input_dim[1]
        canvas, boxes, img_id = self._assemble_mosaic(
            idx, rng, out_h, out_w)

        canvas, boxes = random_affine(
            canvas, boxes, rng=rng, target_size=(out_w, out_h),
            degrees=self.degrees, translate=self.translate,
            scales=self.scale, shear=self.shear)

        if (self.enable_mixup and len(boxes) > 0
                and rng.random() < self.mixup_prob):
            canvas, boxes = self.mixup(canvas, boxes, self.input_dim, rng)
        img, padded_labels = self.preproc(
            canvas, boxes, self.input_dim, rng=rng)
        return img, padded_labels, (img.shape[1], img.shape[0]), img_id

    def _assemble_mosaic(self, idx, rng, out_h, out_w):
        """Paste 4 letterbox-scaled images around a random center on a
        (2H, 2W) canvas; return the canvas, the canvas-space boxes, and
        the primary image id."""
        yc = int(rng.uniform(0.5 * out_h, 1.5 * out_h))
        xc = int(rng.uniform(0.5 * out_w, 1.5 * out_w))
        picks = [idx] + [int(i) for i in
                         rng.integers(0, len(self._dataset), 3)]

        tiles, anns, ratios, img_id = [], [], [], None
        for t, index in enumerate(picks):
            img, labels, _, iid = self._dataset.pull_item(index)
            if t == 0:
                img_id = iid
            r = min(out_h / img.shape[0], out_w / img.shape[1])
            tiles.append(resize_linear(
                img, (int(img.shape[1] * r), int(img.shape[0] * r))))
            anns.append(np.asarray(labels, np.float64).reshape(-1, 5))
            ratios.append(r)

        tile_hw = np.array([t.shape[:2] for t in tiles])
        paste, shift = mosaic_geometry(tile_hw, xc, yc, out_h, out_w)

        canvas = np.full((2 * out_h, 2 * out_w, tiles[0].shape[2]),
                         _PAD, dtype=np.uint8)
        for t in range(4):
            x1, y1, x2, y2 = paste[t]
            ox, oy = shift[t]
            canvas[y1:y2, x1:x2] = tiles[t][y1 - oy:y2 - oy, x1 - ox:x2 - ox]

        # one label transform over all tiles: scale to tile space, shift
        # into the canvas, clip to the canvas bounds
        boxes = np.concatenate(anns, axis=0)
        owner = np.repeat(np.arange(4), [len(a) for a in anns])
        scale = np.asarray(ratios)[owner, None]
        boxes[:, :4] = boxes[:, :4] * scale + np.tile(shift[owner], 2)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * out_w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * out_h)
        return canvas, boxes, img_id

    def mixup(self, img, labels, input_dim, rng):
        """CopyPaste-style MixUp: letterbox a random annotated partner to
        `input_dim`, jitter-rescale, optionally flip, crop a window the
        size of `img` at a random position, and blend 50/50 (the
        reference's mixup, mosaicdetection.py:160-232)."""
        th, tw = img.shape[:2]
        jit = rng.uniform(*self.mixup_scale)
        flip = rng.uniform(0, 1) > 0.5

        while True:
            k = int(rng.integers(0, len(self)))
            if len(self._dataset.load_anno(k)):
                break
        partner, panns, _, _ = self._dataset.pull_item(k)

        # letterbox (pad 114 top-left) then rescale the whole canvas by the
        # jitter factor; r maps partner-space boxes to the jittered canvas
        boxed = np.full((input_dim[0], input_dim[1], 3), _PAD, np.uint8)
        r = min(input_dim[0] / partner.shape[0],
                input_dim[1] / partner.shape[1])
        boxed[:int(partner.shape[0] * r), :int(partner.shape[1] * r)] = \
            resize_linear(partner, (int(partner.shape[1] * r),
                                    int(partner.shape[0] * r)))
        boxed = resize_linear(
            boxed, (int(boxed.shape[1] * jit), int(boxed.shape[0] * jit)))
        r *= jit
        if flip:
            boxed = boxed[:, ::-1, :]
        jh, jw = boxed.shape[:2]

        # crop window of the target size at a random offset (only the axes
        # where the jittered canvas exceeds the target have freedom)
        dy = int(rng.integers(0, jh - th)) if jh > th else 0
        dx = int(rng.integers(0, jw - tw)) if jw > tw else 0
        window = np.zeros((max(jh, th), max(jw, tw), 3), np.uint8)
        window[:jh, :jw] = boxed
        crop = window[dy:dy + th, dx:dx + tw]

        # partner boxes through the same chain: scale+clip to the jittered
        # canvas, mirror, crop shift, clip to the target window
        pboxes = adjust_box_anns(panns[:, :4].copy(), r, 0, 0, jw, jh)
        if flip:
            pboxes[:, [0, 2]] = jw - pboxes[:, [2, 0]]
        pboxes[:, [0, 2]] = np.clip(pboxes[:, [0, 2]] - dx, 0, tw)
        pboxes[:, [1, 3]] = np.clip(pboxes[:, [1, 3]] - dy, 0, th)

        labels = np.vstack([labels, np.hstack([pboxes, panns[:, 4:5]])])
        blended = 0.5 * img.astype(np.float32) + 0.5 * crop.astype(
            np.float32)
        return blended.astype(np.uint8), labels
