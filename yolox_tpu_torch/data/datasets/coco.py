"""COCO detection dataset, the port's copy of the JAX package's
`yolox_tpu/data/datasets/coco.py` (upstream YOLOX's, on the pure-python
COCO JSON parser `data/coco_json.py` instead of pycocotools).

Same protocol: annotations pre-loaded to memory (segmentation stripped),
boxes clipped to xyxy, class index = position in sorted category ids,
images pre-resized by r = min(target/h, target/w); `pull_item` returns
(BGR uint8 image, (N, 5) xyxy+cls labels, (h, w), img_id).

cv2 is imported only where an image is read or resized, with Pillow as
the fallback, and an image already at the target scale is not resized
at all (`ops/preproc.py` does the same), so a subclass that makes its
images in memory needs neither.
"""

from __future__ import annotations

import copy
import os

import numpy as np

from yolox_tpu_torch.data.coco_json import COCO
from yolox_tpu_torch.data.dataloading import get_yolox_datadir
from yolox_tpu_torch.data.datasets.datasets_wrapper import (
    CacheDataset,
    cache_read_img,
)
from yolox_tpu_torch.ops.preproc import _resize_linear

_DROP_TOP = ("info", "licenses")
_DROP_IMG = ("license", "coco_url", "date_captured", "flickr_url")


def remove_useless_info(coco: COCO):
    """Strip segmentation/license info to save memory (upstream
    `coco.py:13-29`)."""
    data = coco.dataset
    for key in _DROP_TOP:
        data.pop(key, None)
    for img in data.get("images", []):
        for key in _DROP_IMG:
            img.pop(key, None)
    for anno in data.get("annotations", []):
        anno.pop("segmentation", None)


def _clean_boxes(annos, width, height, class_index):
    """(N, 5) xyxy+cls rows from raw COCO annotations: clip to the image,
    drop degenerate/zero-area boxes, map category id -> class index."""
    rows = []
    for a in annos:
        bx, by, bw, bh = a["bbox"]
        x1 = max(0.0, bx)
        y1 = max(0.0, by)
        x2 = min(float(width), x1 + max(0.0, bw))
        y2 = min(float(height), y1 + max(0.0, bh))
        if a["area"] > 0 and x2 >= x1 and y2 >= y1:
            rows.append((x1, y1, x2, y2, class_index[a["category_id"]]))
    return np.asarray(rows, np.float64).reshape(len(rows), 5)


def read_bgr(path):
    """An image file as an HWC BGR uint8 array (cv2's layout), or None
    when it cannot be read: cv2 if present, else Pillow."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.imread(path, cv2.IMREAD_COLOR)
    from PIL import Image

    try:
        with Image.open(path) as im:
            return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])
    except OSError:
        return None


def resize_to_fit(img, size):
    """`img` scaled by r = min(h_t / h, w_t / w) with cv2 INTER_LINEAR, as
    uint8; returned as it is when r is 1."""
    r = min(size[0] / img.shape[0], size[1] / img.shape[1])
    size_wh = (int(img.shape[1] * r), int(img.shape[0] * r))
    if size_wh == (img.shape[1], img.shape[0]):
        return img.astype(np.uint8)
    return _resize_linear(img, size_wh).astype(np.uint8)


class CocoDataset(CacheDataset):
    def __init__(self, data_dir=None, json_file="instances_train2017.json",
                 name="train2017", img_size=(416, 416), preproc=None,
                 cache=False, cache_type="ram"):
        self.data_dir = data_dir if data_dir is not None else os.path.join(
            get_yolox_datadir(), "COCO")
        self.json_file = json_file
        self.name = name
        self.img_size = img_size
        self.preproc = preproc

        self.coco = COCO(os.path.join(
            self.data_dir, "annotations", json_file))
        remove_useless_info(self.coco)
        self.ids = self.coco.getImgIds()
        self.num_imgs = len(self.ids)
        self.class_ids = sorted(self.coco.getCatIds())
        self.cats = self.coco.loadCats(self.coco.getCatIds())
        self._classes = tuple(c["name"] for c in self.cats)
        self._cls_index = {cid: i for i, cid in enumerate(self.class_ids)}
        self.annotations = [self.load_anno_from_ids(i) for i in self.ids]

        super().__init__(
            input_dimension=img_size,
            num_imgs=self.num_imgs,
            data_dir=self.data_dir,
            cache_dir_name=f"cache_{name}",
            path_filename=[os.path.join(name, entry[3])
                           for entry in self.annotations],
            cache=cache,
            cache_type=cache_type,
        )

    def __len__(self):
        return self.num_imgs

    def load_anno_from_ids(self, id_):
        """(labels, (h, w), (resized h, w), file_name) for one image id;
        labels are pre-scaled by the letterbox ratio (upstream
        `coco.py:110-139`)."""
        meta = self.coco.loadImgs(id_)[0]
        height, width = meta["height"], meta["width"]
        annos = self.coco.loadAnns(
            self.coco.getAnnIds(imgIds=[int(id_)], iscrowd=False))
        labels = _clean_boxes(annos, width, height, self._cls_index)

        r = min(self.img_size[0] / height, self.img_size[1] / width)
        labels[:, :4] *= r
        file_name = meta.get("file_name", f"{id_:012}.jpg")
        return (labels, (height, width),
                (int(height * r), int(width * r)), file_name)

    def load_anno(self, index):
        return self.annotations[index][0]

    def load_image(self, index):
        path = os.path.join(self.data_dir, self.name,
                            self.annotations[index][3])
        img = read_bgr(path)
        assert img is not None, f"file named {path} not found"
        return img

    def load_resized_img(self, index):
        return resize_to_fit(self.load_image(index), self.img_size)

    @cache_read_img(use_cache=True)
    def read_img(self, index):
        return self.load_resized_img(index)

    def pull_item(self, index):
        labels, origin_size, _, _ = self.annotations[index]
        return (self.read_img(index), copy.deepcopy(labels), origin_size,
                np.array([self.ids[index]]))

    @CacheDataset.mosaic_getitem
    def __getitem__(self, index):
        img, target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.input_dim,
                                       rng=self.rng)
        return img, target, img_info, img_id
