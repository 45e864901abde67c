"""The gate's fixture for the port's harness tests: an amplified nano
`.pth`, three synthetic images and the JAX package's detections on them
(`jax_fixture`), and a COCO set of those images whose ground truth is
those detections (`coco_dir`), so that an evaluation of the fixture
measures a mAP well above zero.
"""

from __future__ import annotations

import json
from pathlib import Path

from chip_smoke import (
    GATE_SIZES,
    amplified_nano_pth,
    expectations_of,
    gate_images,
)


def jax_fixture(root):
    """`root/yolox_nano.pth` (amplified nano) and `gate_images(root)`;
    returns (images, expectations {"yolox_nano": rows}) with the rows the
    JAX package's `Yolox.from_pretrained` pipeline gives at 0.5."""
    from PIL import Image

    from yolox_tpu import Yolox as JYolox
    from yolox_tpu import YoloxConfig as JConfig

    ckpt = Path(root) / "yolox_nano.pth"
    amplified_nano_pth(ckpt)
    images = gate_images(root)
    model = JYolox.from_pretrained(
        str(ckpt), config=JConfig.get_named_config("yolox_nano"))
    results = model([Image.open(p) for p in images], threshold=0.5)
    return images, {"yolox_nano": expectations_of(results)}


def coco_dir(root, images, expectations):
    """val2017 + annotations under `root`: the fixture's images, their
    ground truth the detections `expectations` (label l -> category id
    l + 1). The evaluators read files with cv2 (BGR) where
    `Yolox.__call__` takes Pillow's RGB, so each image is stored with its
    channels swapped: the evaluation then sees the arrays the detections
    came from."""
    import cv2

    from yolox_tpu_torch.data import COCO_CLASSES

    root = Path(root)
    (root / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    imgs, anns = [], []
    for i, (path, exp) in enumerate(zip(images, expectations)):
        cv2.imwrite(str(root / "val2017" / Path(path).name),
                    cv2.imread(path)[..., ::-1])
        h, w = GATE_SIZES[i]
        imgs.append({"id": i, "width": w, "height": h,
                     "file_name": Path(path).name})
        for label, (x1, y1, x2, y2) in zip(exp["labels"], exp["bboxes"]):
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": label + 1,
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "area": (x2 - x1) * (y2 - y1), "iscrowd": 0})
    cats = [{"id": j + 1, "name": n} for j, n in enumerate(COCO_CLASSES)]
    (root / "annotations" / "instances_val2017.json").write_text(json.dumps(
        {"images": imgs, "annotations": anns, "categories": cats}))
