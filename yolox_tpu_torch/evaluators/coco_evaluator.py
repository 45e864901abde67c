"""COCO mAP evaluator, the port's counterpart of the JAX package's
`yolox_tpu/evaluators/coco_evaluator.py` (upstream YOLOX's
`coco_evaluator.py`).

Batched inference on the module's device with the device postprocess
(`ops/nms.py::postprocess_device`: top-k, decode, and the NMS kernel K2),
results converted to COCO json format on the host (rescale by
1/letterbox-ratio, xyxy -> xywh, class index -> COCO category id) and
evaluated with the self-contained COCOeval (`evaluators/cocoeval.py`).
CUDA launches are asynchronous, so batch k+1 is dispatched before batch
k's detections are fetched and converted. Gathering detections from
several processes comes with `torch.distributed` in the trainer (ROADMAP
M7); until then more than one process raises.
"""

from __future__ import annotations

import io
import itertools
import time
from collections import defaultdict
from contextlib import redirect_stdout

import numpy as np
import torch

from yolox_tpu_torch.data.datasets.coco_classes import COCO_CLASSES
from yolox_tpu_torch.ops.preproc import letterbox_ratio
from yolox_tpu_torch.utils.logger import logger


def process_rank_and_count():
    """(rank, world size) of `torch.distributed` when it is initialized,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def require_one_process(what: str) -> None:
    if process_rank_and_count()[1] > 1:
        raise NotImplementedError(
            f"{what} across processes gathers detections with "
            "torch.distributed, which comes with the trainer (ROADMAP M7); "
            "evaluate in one process")


def model_device(model) -> torch.device:
    """The device a model runs on: its `device` attribute (a YoloxModule's
    parameters' device), else its first parameter's."""
    device = getattr(model, "device", None)
    if device is None and isinstance(model, torch.nn.Module):
        device = next(model.parameters()).device
    if device is None:
        raise ValueError("the evaluated model needs a `device` attribute or "
                         "parameters: inference runs on its device")
    return torch.device(device)


def device_inference(model, imgs, half, num_classes, confthre, nmsthre,
                     max_det):
    """One batch on the model's device: the (B, H, W, 3) batch moved there
    (bf16 when `half`), the decoded output cast to float32 and
    `postprocess_device`. Returns (dets, valid) on the device, still being
    computed."""
    from yolox_tpu_torch.ops.nms import postprocess_device

    xin = torch.as_tensor(imgs).to(model_device(model))
    if half:
        xin = xin.to(torch.bfloat16)
    out = model(xin).float()
    return postprocess_device(out, num_classes, conf_thre=confthre,
                              nms_thre=nmsthre, class_agnostic=False,
                              max_det=max_det)


def _format_table(rows, headers, columns=6):
    """Markdown-ish per-class table (tabulate-free)."""
    result_pair = [x for pair in rows for x in pair]
    num_cols = min(columns, len(rows) * len(headers))
    row_pair = itertools.zip_longest(
        *[result_pair[i::num_cols] for i in range(num_cols)], fillvalue="")
    table_headers = headers * (num_cols // len(headers))
    lines = ["| " + " | ".join(table_headers) + " |",
             "|" + "---|" * num_cols]
    for row in row_pair:
        cells = [f"{c:.3f}" if isinstance(c, float) else str(c)
                 for c in row]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def per_class_AP_table(coco_eval, class_names=COCO_CLASSES,  # noqa: N802
                       headers=("class", "AP"), columns=6):
    per_class_AP = {}
    precisions = coco_eval.eval["precision"]
    assert len(class_names) == precisions.shape[2]
    for idx, name in enumerate(class_names):
        precision = precisions[:, :, idx, 0, -1]
        precision = precision[precision > -1]
        ap = np.mean(precision) if precision.size else float("nan")
        per_class_AP[name] = float(ap * 100)
    return _format_table(
        list(per_class_AP.items()), list(headers), columns)


def per_class_AR_table(coco_eval, class_names=COCO_CLASSES,  # noqa: N802
                       headers=("class", "AR"), columns=6):
    per_class_AR = {}
    recalls = coco_eval.eval["recall"]
    assert len(class_names) == recalls.shape[1]
    for idx, name in enumerate(class_names):
        recall = recalls[:, idx, 0, -1]
        recall = recall[recall > -1]
        ar = np.mean(recall) if recall.size else float("nan")
        per_class_AR[name] = float(ar * 100)
    return _format_table(
        list(per_class_AR.items()), list(headers), columns)


def xyxy2xywh_np(bboxes):
    bboxes = bboxes.copy()
    bboxes[:, 2] = bboxes[:, 2] - bboxes[:, 0]
    bboxes[:, 3] = bboxes[:, 3] - bboxes[:, 1]
    return bboxes


class CocoEvaluator:
    def __init__(self, dataloader, img_size, confthre, nmsthre,
                 num_classes, testdev=False, per_class_AP=True,  # noqa: N803
                 per_class_AR=True, max_det=1024):  # noqa: N803
        self.dataloader = dataloader
        self.img_size = img_size
        self.confthre = confthre
        self.nmsthre = nmsthre
        self.num_classes = num_classes
        self.testdev = testdev
        self.per_class_AP = per_class_AP
        self.per_class_AR = per_class_AR
        self.max_det = max_det
        # after evaluate: COCOeval's matching path ("native" / "python")
        # and its 12 statistics
        self.matcher = None
        self.stats = None

    def evaluate(self, model, distributed=False, half=False,
                 return_outputs=False, decoder=None, test_size=None):
        """Returns (ap50_95, ap50, summary_str)[, image-wise outputs].

        `model` maps a (B, H, W, 3) batch on its device to the decoded
        (B, A, 5 + C) output (a `YoloxModule`). half=True runs the forward
        in bfloat16 (input cast to bf16, decoded output cast back to f32
        so postprocess/NMS stay full-precision) — the reference's fp16
        eval flag; pass a bf16 module for a bf16 forward.
        """
        if distributed:
            require_one_process("COCO evaluation")
        data_list = []       # dict path (return_outputs) | columnar dicts
        output_data = defaultdict(dict)
        inference_time = 0.0
        n_samples = max(len(self.dataloader) - 1, 1)

        # software pipelining: dispatch batch k+1 before fetching batch k's
        # results, so host-side COCO conversion overlaps device compute
        # (asynchronous CUDA launches)
        pending = None  # (device_dets, device_valid, info_imgs, ids, timed)

        def drain(p):
            nonlocal inference_time
            dev_dets, dev_valid, p_info, p_ids, timed = p
            t0 = time.time()
            dets = dev_dets.cpu().numpy()   # fetch = sync point
            valid = dev_valid.cpu().numpy()
            if timed:
                inference_time += time.time() - t0
            # only materialize the per-image output dicts when the caller
            # asked for them: at scale they double the conversion's host
            # memory
            if return_outputs:
                data_list_elem, image_wise_data = (
                    self.convert_to_coco_format(
                        dets, valid, p_info, p_ids, return_outputs=True))
                output_data.update(image_wise_data)
                data_list.extend(data_list_elem)
            else:
                # columnar per-batch arrays: no per-detection dicts on
                # the default eval path (see convert_to_coco_columnar)
                data_list.append(self.convert_to_coco_columnar(
                    dets, valid, p_info, p_ids))

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

        statistics = np.array(
            [inference_time, 0.0, float(n_samples)], np.float64)
        if not return_outputs:
            # concatenate the per-batch columnar chunks into one flat
            # columnar dict
            data_list = {
                k: (np.concatenate([c[k] for c in data_list])
                    if data_list else np.zeros(
                        (0, 4) if k == "bbox" else 0,
                        np.float64 if k in ("bbox", "score") else np.int64))
                for k in ("image_id", "category_id", "bbox", "score")
            }
        eval_results = self.evaluate_prediction(data_list, statistics)
        if return_outputs:
            return eval_results, dict(output_data)
        return eval_results

    def convert_to_coco_format(self, dets, valid, info_imgs, ids,
                               return_outputs=False):
        """dets: (B, K, 7) rows (x1,y1,x2,y2,obj,cls_conf,cls); valid (B,K)."""
        data_list = []
        image_wise_data = defaultdict(dict)
        class_ids = self.dataloader.dataset.class_ids
        for i, (img_info, img_id) in enumerate(zip(info_imgs, ids)):
            img_h, img_w = img_info
            rows = dets[i][valid[i]]
            if rows.shape[0] == 0:
                continue
            scale = letterbox_ratio(
                (float(img_h), float(img_w)), self.img_size)
            bboxes = rows[:, 0:4] / scale
            cls = rows[:, 6]
            scores = rows[:, 4] * rows[:, 5]

            img_id_int = int(np.asarray(img_id).reshape(-1)[0])
            image_wise_data[img_id_int] = {
                "bboxes": [b.tolist() for b in bboxes],
                "scores": [float(s) for s in scores],
                "categories": [class_ids[int(c)] for c in cls],
            }
            bboxes_xywh = xyxy2xywh_np(bboxes)
            for ind in range(bboxes_xywh.shape[0]):
                data_list.append({
                    "image_id": img_id_int,
                    "category_id": class_ids[int(cls[ind])],
                    "bbox": bboxes_xywh[ind].tolist(),
                    "score": float(scores[ind]),
                    "segmentation": [],
                })
        if return_outputs:
            return data_list, image_wise_data
        return data_list

    def convert_to_coco_columnar(self, dets, valid, info_imgs, ids):
        """Columnar variant of `convert_to_coco_format`: flat numpy arrays
        {image_id, category_id, bbox (xywh), score} — no per-detection
        python dicts. Same values as the dict path (f32 -> f64 casts);
        consumed by `coco_json.COCO.loadRes` / `cocoeval._dt_columnar`.
        Per-detection dicts take tens of GB of host memory at millions of
        detections."""
        class_ids = np.asarray(self.dataloader.dataset.class_ids, np.int64)
        img_col, cat_col, box_col, score_col = [], [], [], []
        for i, (img_info, img_id) in enumerate(zip(info_imgs, ids)):
            img_h, img_w = img_info
            rows = dets[i][valid[i]]
            if rows.shape[0] == 0:
                continue
            scale = letterbox_ratio(
                (float(img_h), float(img_w)), self.img_size)
            # xywh computed in f32 then widened — bit-identical to the
            # dict path's tolist() of the f32 xyxy2xywh result
            bboxes = xyxy2xywh_np(rows[:, 0:4] / scale).astype(np.float64)
            img_id_int = int(np.asarray(img_id).reshape(-1)[0])
            img_col.append(np.full(rows.shape[0], img_id_int, np.int64))
            cat_col.append(class_ids[rows[:, 6].astype(np.int64)])
            box_col.append(bboxes)
            score_col.append(
                (rows[:, 4] * rows[:, 5]).astype(np.float64))
        if not img_col:
            return {
                "image_id": np.zeros(0, np.int64),
                "category_id": np.zeros(0, np.int64),
                "bbox": np.zeros((0, 4), np.float64),
                "score": np.zeros(0, np.float64),
            }
        return {
            "image_id": np.concatenate(img_col),
            "category_id": np.concatenate(cat_col),
            "bbox": np.concatenate(box_col),
            "score": np.concatenate(score_col),
        }

    def evaluate_prediction(self, data_dict, statistics):
        """`data_dict`: per-ann dict list OR a columnar dict of arrays
        (both accepted by `coco_json.COCO.loadRes`)."""
        if process_rank_and_count()[0] != 0:
            return 0, 0, None
        n_dets = (len(data_dict["score"]) if isinstance(data_dict, dict)
                  else len(data_dict))
        logger.info(f"Evaluate in main process... ({n_dets} detections)")

        inference_time = statistics[0]
        n_samples = statistics[2]
        batch_size = getattr(self.dataloader.batch_sampler, "batch_size", 1)
        a_infer_time = 1000 * inference_time / (n_samples * batch_size)
        # NOTE: pipelined measurement — async dispatch time plus the fetch
        # of the previous batch, partially overlapped by host-side COCO
        # conversion. It is end-to-end eval wall time per image, NOT pure
        # forward latency.
        info = (f"Average pipelined inference time (fwd+NMS, overlapped): "
                f"{a_infer_time:.2f} ms\n")

        if n_dets > 0:
            from yolox_tpu_torch.evaluators.cocoeval import COCOeval

            cocoGt = self.dataloader.dataset.coco
            cocoDt = cocoGt.loadRes(data_dict)
            cocoEval = COCOeval(cocoGt, cocoDt, "bbox")
            cocoEval.evaluate()
            self.matcher = cocoEval.matcher
            cocoEval.accumulate()
            redirect_string = io.StringIO()
            with redirect_stdout(redirect_string):
                cocoEval.summarize()
            self.stats = np.asarray(cocoEval.stats)
            info += redirect_string.getvalue()
            cat_ids = list(cocoGt.cats.keys())
            cat_names = [cocoGt.cats[c]["name"] for c in sorted(cat_ids)]
            if self.per_class_AP:
                info += "per class AP:\n" + per_class_AP_table(
                    cocoEval, class_names=cat_names) + "\n"
            if self.per_class_AR:
                info += "per class AR:\n" + per_class_AR_table(
                    cocoEval, class_names=cat_names) + "\n"
            return cocoEval.stats[0], cocoEval.stats[1], info
        return 0, 0, info

