"""PASCAL VOC detection dataset, the port's copy of the JAX package's
`yolox_tpu/data/datasets/voc.py` (upstream YOLOX's): XML annotation
parsing, the same pull_item protocol, and built-in VOC mAP evaluation
(result-file writing + `voc_eval` over IoU .5:.95). Images are read as in
`coco.py` (cv2, else Pillow).
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from yolox_tpu_torch.data.datasets.coco import read_bgr, resize_to_fit
from yolox_tpu_torch.data.datasets.datasets_wrapper import (
    CacheDataset,
    cache_read_img,
)
from yolox_tpu_torch.data.datasets.voc_classes import VOC_CLASSES
from yolox_tpu_torch.evaluators.voc_eval import voc_eval
from yolox_tpu_torch.utils.logger import logger


class AnnotationTransform:
    """VOC XML -> (N, 5) array of [xmin, ymin, xmax, ymax, label_idx]
    (upstream `voc.py:21-77`; VOC's 1-based pixel convention preserved)."""

    def __init__(self, class_to_ind=None, keep_difficult=True):
        self.class_to_ind = class_to_ind or dict(
            zip(VOC_CLASSES, range(len(VOC_CLASSES))))
        self.keep_difficult = keep_difficult

    def __call__(self, target):
        res = np.empty((0, 5))
        for obj in target.iter("object"):
            difficult = obj.find("difficult")
            difficult = (int(difficult.text) == 1
                         if difficult is not None else False)
            if not self.keep_difficult and difficult:
                continue
            name = obj.find("name").text.strip()
            bbox = obj.find("bndbox")
            bndbox = [
                int(float(bbox.find(pt).text)) - 1
                for pt in ("xmin", "ymin", "xmax", "ymax")
            ]
            bndbox.append(self.class_to_ind[name])
            res = np.vstack((res, bndbox))

        width = int(target.find("size").find("width").text)
        height = int(target.find("size").find("height").text)
        return res, (height, width)


class VocDetection(CacheDataset):
    def __init__(self, data_dir,
                 image_sets=(("2007", "trainval"), ("2012", "trainval")),
                 img_size=(416, 416), preproc=None,
                 target_transform=None, dataset_name="VOC0712",
                 cache=False, cache_type="ram"):
        self.root = data_dir
        self.image_set = image_sets
        self.img_size = img_size
        self.preproc = preproc
        self.target_transform = target_transform or AnnotationTransform()
        self.name = dataset_name
        self._annopath = os.path.join("%s", "Annotations", "%s.xml")
        self._imgpath = os.path.join("%s", "JPEGImages", "%s.jpg")
        self._classes = VOC_CLASSES
        self.cats = [{"id": idx, "name": val}
                     for idx, val in enumerate(VOC_CLASSES)]
        self.class_ids = list(range(len(VOC_CLASSES)))
        self.ids = []
        for (year, name) in image_sets:
            self._year = year
            rootpath = os.path.join(self.root, "VOC" + year)
            for line in open(os.path.join(
                    rootpath, "ImageSets", "Main", name + ".txt")):
                self.ids.append((rootpath, line.strip()))
        self.num_imgs = len(self.ids)
        self.annotations = [
            self.load_anno_from_ids(i) for i in range(self.num_imgs)]

        path_filename = [
            (self._imgpath % self.ids[i]).split(self.root + "/")[1]
            for i in range(self.num_imgs)
        ]
        super().__init__(
            input_dimension=img_size,
            num_imgs=self.num_imgs,
            data_dir=self.root,
            cache_dir_name=f"cache_{self.name}",
            path_filename=path_filename,
            cache=cache,
            cache_type=cache_type,
        )

    def __len__(self):
        return self.num_imgs

    def load_anno_from_ids(self, index):
        img_id = self.ids[index]
        target = ET.parse(self._annopath % img_id).getroot()
        res, img_info = self.target_transform(target)
        height, width = img_info
        r = min(self.img_size[0] / height, self.img_size[1] / width)
        res[:, :4] *= r
        resized_info = (int(height * r), int(width * r))
        return (res, img_info, resized_info)

    def load_anno(self, index):
        return self.annotations[index][0]

    def load_resized_img(self, index):
        return resize_to_fit(self.load_image(index), self.img_size)

    def load_image(self, index):
        img_id = self.ids[index]
        img = read_bgr(self._imgpath % img_id)
        assert img is not None, \
            f"file named {self._imgpath % img_id} not found"
        return img

    @cache_read_img(use_cache=True)
    def read_img(self, index):
        return self.load_resized_img(index)

    def pull_item(self, index):
        target, img_info, _ = self.annotations[index]
        img = self.read_img(index)
        return img, target, img_info, index

    @CacheDataset.mosaic_getitem
    def __getitem__(self, index):
        img, target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.input_dim,
                                       rng=self.rng)
        return img, target, img_info, img_id

    # --------------- evaluation (upstream `voc.py:219-329`) ---------------

    def evaluate_detections(self, all_boxes, output_dir=None):
        self._write_voc_results_file(all_boxes)
        iou_thresholds = np.linspace(
            0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1, endpoint=True)
        mAPs = [self._do_python_eval(output_dir, iou)
                for iou in iou_thresholds]
        logger.info(f"map_5095: {np.mean(mAPs)}")
        logger.info(f"map_50: {mAPs[0]}")
        return np.mean(mAPs), mAPs[0]

    def _get_voc_results_file_template(self):
        filename = "comp4_det_test_{:s}.txt"
        filedir = os.path.join(
            self.root, "results", "VOC" + self._year, "Main")
        os.makedirs(filedir, exist_ok=True)
        return os.path.join(filedir, filename)

    def _write_voc_results_file(self, all_boxes):
        for cls_ind, cls in enumerate(VOC_CLASSES):
            logger.info(f"Writing {cls} VOC results file")
            filename = self._get_voc_results_file_template().format(cls)
            with open(filename, "wt") as f:
                for im_ind, index in enumerate(self.ids):
                    index = index[1]
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        f.write(
                            "{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n".
                            format(index, dets[k, -1], dets[k, 0] + 1,
                                   dets[k, 1] + 1, dets[k, 2] + 1,
                                   dets[k, 3] + 1))

    def _do_python_eval(self, output_dir="output", iou=0.5):
        rootpath = os.path.join(self.root, "VOC" + self._year)
        name = self.image_set[0][1]
        annopath = os.path.join(rootpath, "Annotations", "{:s}.xml")
        imagesetfile = os.path.join(
            rootpath, "ImageSets", "Main", name + ".txt")
        cachedir = os.path.join(
            self.root, "annotations_cache", "VOC" + self._year, name)
        os.makedirs(cachedir, exist_ok=True)
        use_07_metric = int(self._year) < 2010
        if output_dir is not None and not os.path.isdir(output_dir):
            os.makedirs(output_dir, exist_ok=True)
        aps = []
        for i, cls in enumerate(VOC_CLASSES):
            filename = self._get_voc_results_file_template().format(cls)
            rec, prec, ap = voc_eval(
                filename, annopath, imagesetfile, cls, cachedir,
                ovthresh=iou, use_07_metric=use_07_metric)
            aps.append(ap)
            if iou == 0.5:
                logger.info(f"AP for {cls} = {ap:.4f}")
            if output_dir is not None:
                with open(os.path.join(
                        output_dir, cls + "_pr.pkl"), "wb") as f:
                    pickle.dump({"rec": rec, "prec": prec, "ap": ap}, f)
        if iou == 0.5:
            logger.info(f"Mean AP = {np.mean(aps):.4f}")
        return np.mean(aps)
