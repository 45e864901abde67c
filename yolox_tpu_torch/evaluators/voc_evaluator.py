"""VOC mAP evaluator, the port's counterpart of the JAX package's
`yolox_tpu/evaluators/voc_evaluator.py` (upstream YOLOX's
`voc_evaluator.py`): the inference path of `CocoEvaluator` (the module's
device, `postprocess_device` with K2, batch k+1 dispatched before batch k
is fetched), per-class box lists handed to
`VocDetection.evaluate_detections` (voc_eval over IoU .5:.95). With
`distributed` the ranks' detections are gathered and rank 0 computes the
mAP, as in `CocoEvaluator`.
"""

from __future__ import annotations

import time

import numpy as np

from yolox_tpu_torch.evaluators.coco_evaluator import device_inference
from yolox_tpu_torch.ops.preproc import letterbox_ratio
from yolox_tpu_torch.parallel.mesh import (
    all_gather_objects,
    is_main_process,
    process_count,
)
from yolox_tpu_torch.utils.logger import logger


class VocEvaluator:
    def __init__(self, dataloader, img_size, confthre, nmsthre,
                 num_classes, max_det=1024):
        self.dataloader = dataloader
        self.img_size = img_size
        self.confthre = confthre
        self.nmsthre = nmsthre
        self.num_classes = num_classes
        self.num_images = len(dataloader.dataset)
        self.max_det = max_det

    def evaluate(self, model, distributed=False, half=False,
                 return_outputs=False, decoder=None, test_size=None):
        data_dict = {}
        inference_time = 0.0
        n_samples = max(len(self.dataloader) - 1, 1)

        # software pipelining, as in CocoEvaluator: dispatch batch k+1
        # before fetching batch k so conversion overlaps device compute
        pending = None

        def drain(p):
            nonlocal inference_time
            dev_dets, dev_valid, p_info, p_ids, timed = p
            t0 = time.time()
            dets = dev_dets.cpu().numpy()   # fetch = sync point
            valid = dev_valid.cpu().numpy()
            if timed:
                inference_time += time.time() - t0
            data_dict.update(
                self.convert_to_voc_format(dets, valid, p_info, p_ids))

        for cur_iter, (imgs, _, info_imgs, ids) in enumerate(
                self.dataloader):
            is_time_record = cur_iter < len(self.dataloader) - 1
            if is_time_record:
                start = time.time()
            dets, valid = device_inference(     # asynchronous
                model, imgs, half, self.num_classes, self.confthre,
                self.nmsthre, self.max_det)
            if is_time_record:
                inference_time += time.time() - start
            prev, pending = pending, (dets, valid, info_imgs, ids,
                                      is_time_record)
            if prev is not None:
                drain(prev)
        if pending is not None:
            drain(pending)

        if distributed and process_count() > 1:
            merged = {}
            for d in all_gather_objects(data_dict):
                merged.update(d)
            data_dict = merged

        if not is_main_process():
            return 0, 0, None

        batch_size = getattr(self.dataloader.batch_sampler, "batch_size", 1)
        a_infer_time = 1000 * inference_time / (n_samples * batch_size)
        logger.info(
            "Average pipelined inference time (fwd+NMS, overlapped): "
            f"{a_infer_time:.2f} ms")

        all_boxes = [
            [[] for _ in range(self.num_images)]
            for _ in range(self.num_classes)
        ]
        for img_num in range(self.num_images):
            obj = data_dict.get(img_num)
            if obj is None:
                for j in range(self.num_classes):
                    all_boxes[j][img_num] = np.empty([0, 5],
                                                     dtype=np.float32)
                continue
            bboxes, cls, scores = obj
            for j in range(self.num_classes):
                mask_c = cls == j
                if sum(mask_c) == 0:
                    all_boxes[j][img_num] = np.empty([0, 5],
                                                     dtype=np.float32)
                    continue
                c_dets = np.concatenate(
                    [bboxes[mask_c], scores[mask_c, None]], axis=1)
                all_boxes[j][img_num] = c_dets

        mAP50_95, mAP50 = self.dataloader.dataset.evaluate_detections(
            all_boxes)
        summary = f"mAP50: {mAP50:.4f}, mAP50_95: {mAP50_95:.4f}"
        return mAP50_95, mAP50, summary

    def convert_to_voc_format(self, dets, valid, info_imgs, ids):
        predictions = {}
        for i, (img_info, img_id) in enumerate(zip(info_imgs, ids)):
            img_h, img_w = img_info
            rows = dets[i][valid[i]]
            idx = int(np.asarray(img_id).reshape(-1)[0])
            if rows.shape[0] == 0:
                predictions[idx] = (
                    np.empty((0, 4), np.float32),
                    np.empty((0,), np.int64),
                    np.empty((0,), np.float32),
                )
                continue
            scale = letterbox_ratio(
                (float(img_h), float(img_w)), self.img_size)
            bboxes = rows[:, 0:4] / scale
            cls = rows[:, 6].astype(np.int64)
            scores = rows[:, 4] * rows[:, 5]
            predictions[idx] = (bboxes, cls, scores)
        return predictions
