#!/usr/bin/env python
"""The whole evaluation lane of the PyTorch port (`yolox_tpu_torch`) at
the reference's scale (COCO val2017: 5 000 images) on a synthetic set
built here: the port's counterpart of `scripts/eval_at_scale.py`.

`yolox-tpu-torch eval` (`yolox_tpu_torch.cli.eval.main`) runs on a
random-weight checkpoint: the loader (workers handing float32 batches
over in shared memory) -> batched inference on the device (K1, K2; with
--int8 Q1) -> columnar COCO conversion -> COCOeval (native matching) ->
the per-class tables. The script records the wall time of each stage,
the peak host RSS, the device's peak memory and the throughput, and
catches what a test of 30 images cannot: memory that grows with the
image count, throughput cliffs.

    python scripts/torch_eval_at_scale.py [--images 5000] [--model s]
        [--batch 64] [--root $TMPDIR/yolox_eval5k] [--conf 2e-5] [--int8]
        [--ckpt-dir $TMPDIR/yolox_eval5k_ckpt] [--device {cuda,cpu}]

The dataset is built once and cached under --root, file for file the
JAX script's for the same seed: 80 COCO-named categories with COCO's
non-contiguous ids, image sizes drawn from typical val2017 dimensions,
~7 filled rectangles an image (JPEG quality 70). The default --conf lets
a random-weight model (scores near the bias prior, ~1e-4) keep tens of
detections an image. Prints `EVAL_AT_SCALE {json}`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import resource
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# typical COCO val2017 dimension mix
_SIZES = [(480, 640), (640, 480), (426, 640), (640, 427), (612, 612),
          (375, 500), (640, 426), (500, 375), (429, 640), (640, 640)]


def build_dataset(root: pathlib.Path, n_images: int, seed: int = 0) -> None:
    """Write `val2017/<id>.jpg` and `annotations/instances_val2017.json`
    under `root` (once: a `.complete_<n>` marker says the set is there)."""
    import cv2

    from yolox_tpu_torch.data import COCO_CLASSES

    ann_file = root / "annotations" / "instances_val2017.json"
    marker = root / f".complete_{n_images}"
    if marker.exists():
        return
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    (root / "val2017").mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    # COCO's category ids are not contiguous (1..90 with gaps): the
    # evaluator's id translation runs
    cat_ids = [c for c in range(1, 91) if c % 9 != 0][:80]
    images, annotations = [], []
    ann_id = 1
    t0 = time.time()
    for i in range(n_images):
        h, w = _SIZES[int(rng.integers(len(_SIZES)))]
        img = np.full((h, w, 3), int(rng.integers(40, 216)), np.uint8)
        name = f"{i:012d}.jpg"
        exists = (root / "val2017" / name).exists()
        n_boxes = int(rng.poisson(7)) or 1
        for _ in range(n_boxes):
            bw = float(rng.uniform(8, w * 0.7))
            bh = float(rng.uniform(8, h * 0.7))
            x = float(rng.uniform(0, w - bw))
            y = float(rng.uniform(0, h - bh))
            color = tuple(int(c) for c in rng.integers(0, 255, 3))
            cv2.rectangle(img, (int(x), int(y)), (int(x + bw), int(y + bh)),
                          color, -1)
            annotations.append({
                "id": ann_id, "image_id": i,
                "category_id": int(cat_ids[int(rng.integers(80))]),
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
            })
            ann_id += 1
        if not exists:
            cv2.imwrite(str(root / "val2017" / name), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 70])
        images.append({"id": i, "width": w, "height": h, "file_name": name})
        if i % 1000 == 999:
            print(f"  built {i + 1}/{n_images} images "
                  f"({time.time() - t0:.0f}s)", flush=True)
    categories = [{"id": cid, "name": COCO_CLASSES[j]}
                  for j, cid in enumerate(cat_ids)]
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    marker.touch()
    print(f"dataset ready: {n_images} images, {len(annotations)} gt boxes, "
          f"{time.time() - t0:.0f}s", flush=True)


def random_checkpoint(model: str, ckpt_dir: pathlib.Path) -> pathlib.Path:
    """`random_<model>.pth`: yolox_<model> at `rng_seed` 0 (the JAX
    package's weights for the same seed), through the `.pth` path."""
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.models.weights import save_pth_state_dict

    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ckpt_file = ckpt_dir / f"random_{model}.pth"
    if not ckpt_file.exists():
        config = YoloxConfig.get_named_config(f"yolox_{model}")
        module = YoloxModule.from_config(config, rng_seed=0, device="cpu")
        save_pth_state_dict(module.state_dict(), ckpt_file)
    return ckpt_file


@contextlib.contextmanager
def recording_evaluator(rec: dict):
    """Within the block, `CocoEvaluator` notes in `rec` when its
    evaluation starts (`t_evaluate`), when COCOeval starts and ends
    (`t_cocoeval`, `t_cocoeval_end`), the loop's pipelined inference
    seconds, the detections handed to COCOeval, the image ids among them
    and the 12 statistics."""
    from yolox_tpu_torch.evaluators import CocoEvaluator

    evaluate, predict = (CocoEvaluator.evaluate,
                         CocoEvaluator.evaluate_prediction)

    def timed_evaluate(self, *a, **kw):
        rec["t_evaluate"] = time.perf_counter()
        return evaluate(self, *a, **kw)

    def recorded_prediction(self, data_dict, statistics):
        rec["t_cocoeval"] = time.perf_counter()
        out = predict(self, data_dict, statistics)
        rec["t_cocoeval_end"] = time.perf_counter()
        rec["inference_s"] = float(statistics[0])
        rec["detections"] = int(len(data_dict["score"]))
        rec["image_ids"] = np.unique(data_dict["image_id"]).tolist()
        rec["stats"] = (None if self.stats is None
                        else [float(s) for s in self.stats])
        rec["matcher"] = self.matcher
        return out

    CocoEvaluator.evaluate = timed_evaluate
    CocoEvaluator.evaluate_prediction = recorded_prediction
    try:
        yield rec
    finally:
        CocoEvaluator.evaluate = evaluate
        CocoEvaluator.evaluate_prediction = predict


def run(images=5000, model="s", batch=64, root=None, conf=2e-5, int8=False,
        ckpt_dir=None, device=None):
    """Build the set and the checkpoint, run `eval` in this process;
    returns the report (JAX's fields, then the stages, the detections
    and the image ids that have any)."""
    import torch

    from yolox_tpu_torch.cli import eval as eval_cli
    from yolox_tpu_torch.models.yolox import resolve_device

    tmp = pathlib.Path(tempfile.gettempdir())
    root = pathlib.Path(root or tmp / "yolox_eval5k")
    ckpt_dir = pathlib.Path(ckpt_dir or tmp / "yolox_eval5k_ckpt")
    dev = resolve_device(device)
    build_dataset(root, images)
    ckpt_file = random_checkpoint(model, ckpt_dir)

    # one process (-d 1), as the JAX script is; the command's log goes
    # beside the checkpoint
    argv = ["-c", f"yolox_{model}", "--ckpt", str(ckpt_file),
            "-b", str(batch), "--fp16", "--conf", str(conf),
            "-D", f"data_dir={root}", "-D", f"output_dir={ckpt_dir}",
            "-d", "1", "--device", dev.type]
    if int8:
        argv += ["--int8"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {}
    t_start = time.perf_counter()
    with recording_evaluator(rec):
        rc = eval_cli.main(argv)
    t_end = time.perf_counter()
    wall = t_end - t_start
    return {
        "images": images,
        "model": model,
        "batch": batch,
        "wall_s": round(wall, 1),
        "img_per_s_end_to_end": round(images / wall, 1),
        "peak_host_rss_gb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        "device_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "rc": rc,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "int8": int8,
        "stages_s": {
            "start_up": rec["t_evaluate"] - t_start,
            "inference_loop": rec["t_cocoeval"] - rec["t_evaluate"],
            "cocoeval": rec["t_cocoeval_end"] - rec["t_cocoeval"],
            "tables_and_exit": t_end - rec["t_cocoeval_end"],
        },
        "pipelined_inference_s": rec["inference_s"],
        "detections": rec["detections"],
        "images_with_detections": len(rec["image_ids"]),
        "image_ids": rec["image_ids"],
        "stats": rec["stats"],
        "matcher": rec["matcher"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=5000)
    ap.add_argument("--model", default="s")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--root", default=None,
                    help="dataset directory (default $TMPDIR/yolox_eval5k)")
    ap.add_argument("--conf", type=float, default=2e-5)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default "
                         "$TMPDIR/yolox_eval5k_ckpt)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    report = run(args.images, args.model, args.batch, args.root, args.conf,
                 args.int8, args.ckpt_dir, args.device)
    report.pop("image_ids")
    print("EVAL_AT_SCALE " + json.dumps(report), flush=True)
    return report["rc"]


if __name__ == "__main__":
    sys.exit(main())
