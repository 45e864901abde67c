"""Self-contained COCO annotation API (pycocotools-free), the port's copy
of the JAX package's `yolox_tpu/data/coco_json.py`.

Upstream YOLOX loads datasets and evaluates through pycocotools' COCO
class. This is a small pure-python implementation of the subset the
framework needs: index construction, img/ann/cat lookups, and loadRes for
detection results. Box IoU for evaluation lives in the evaluator
(vectorized numpy / C++), not here.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, List, Optional


class COCO:
    """Minimal drop-in for pycocotools.coco.COCO (bbox tasks)."""

    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            assert isinstance(self.dataset, dict), (
                f"annotation file format {type(self.dataset)} not supported")
            self.create_index()

    # pycocotools-compatible aliases
    @property
    def imgToAnns(self):  # noqa: N802
        return self.img_to_anns

    def create_index(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns, self.cat_to_imgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    createIndex = create_index  # noqa: N815

    def getImgIds(self, imgIds=None, catIds=None):  # noqa: N802,N803
        img_ids = set(imgIds or [])
        cat_ids = catIds or []
        if not img_ids and not cat_ids:
            return list(self.imgs.keys())
        ids = img_ids or set(self.imgs.keys())
        for cat_id in cat_ids:
            ids &= set(self.cat_to_imgs[cat_id])
        return list(ids)

    def getCatIds(self, catNms=None, supNms=None, catIds=None):  # noqa: N802,N803
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None,  # noqa: N802,N803
                  iscrowd=None):
        if imgIds is not None and not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        if imgIds:
            anns = [a for i in imgIds for a in self.img_to_anns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cat_set = set(catIds if isinstance(catIds, (list, tuple))
                          else [catIds])
            anns = [a for a in anns if a["category_id"] in cat_set]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns
                    if bool(a.get("iscrowd", 0)) == bool(iscrowd)]
        return [a["id"] for a in anns]

    def loadAnns(self, ids):  # noqa: N802
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids):  # noqa: N802
        if isinstance(ids, int):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def loadImgs(self, ids):  # noqa: N802
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadRes(self, res):  # noqa: N802
        """Load detection results as a COCO object sharing this object's
        images/categories (bbox results). Accepts a list of per-ann
        dicts, a json path, or a COLUMNAR dict of flat arrays
        {image_id (N,), category_id (N,), bbox (N, 4) xywh, score (N,)}
        — the columnar form never materializes per-detection python
        dicts (the evaluator's default path; consumed directly by
        `evaluators/cocoeval.py:_dt_columnar`)."""
        out = COCO()
        out.dataset["images"] = list(self.dataset.get("images", []))
        out.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        if isinstance(res, dict):
            import numpy as np

            n = len(res["score"])
            col = {
                "image_id": np.asarray(res["image_id"], np.int64),
                "category_id": np.asarray(res["category_id"], np.int64),
                "bbox": np.asarray(res["bbox"],
                                   np.float64).reshape(n, 4),
                "score": np.asarray(res["score"], np.float64),
            }
            unknown = (set(np.unique(col["image_id"]).tolist())
                       - set(self.getImgIds()))
            assert not unknown, "results contain unknown image ids"
            out.dataset["annotations"] = []
            out.columnar = col
            out.create_index()
            return out
        if isinstance(res, str):
            with open(res) as f:
                anns = json.load(f)
        else:
            anns = res
        assert isinstance(anns, list), "results must be a list"
        if anns:
            ann_img_ids = {a["image_id"] for a in anns}
            assert ann_img_ids <= set(self.getImgIds()), (
                "results contain unknown image ids")
        for idx, ann in enumerate(anns):
            if "bbox" in ann:
                bb = ann["bbox"]
                if "area" not in ann:
                    ann["area"] = bb[2] * bb[3]
                ann["id"] = idx + 1
                ann["iscrowd"] = ann.get("iscrowd", 0)
        out.dataset["annotations"] = anns
        out.create_index()
        return out
