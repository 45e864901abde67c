#!/usr/bin/env python
"""A/B the host-memory footprint of the detections' representation in
the port's COCO evaluation: the counterpart of `scripts/eval_memory_ab.py`.

The same synthetic ground truth (7 boxes an image over 80 categories) and
detections (uniform over images and categories), from `default_rng(0)`,
go through `data/coco_json.py::COCO.loadRes` -> `evaluators/cocoeval.py::
COCOeval` (evaluate, accumulate, summarize) once as flat numpy columns
(`columnar`, what `CocoEvaluator` hands over) and once as one Python dict
a detection (`dict`, the reference's COCO protocol). Each mode runs in a
fresh child process (started through a small launcher, so that its
`ru_maxrss` is its own even under a large caller), and prints one JSON
line: `ap`, `convert_s`, `eval_s`, `peak_host_rss_gb` (`ru_maxrss` /
1e6, as JAX's). Needs no device
(a host phase); on the card's machine it measures the host that the
evaluation runs on.

    python scripts/torch_eval_memory_ab.py [--dets 5120000] [--images 5000]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import contextlib, io, json, resource, sys, time
import numpy as np

sys.path.insert(0, {repo!r})
from yolox_tpu_torch.data.coco_json import COCO
from yolox_tpu_torch.evaluators.cocoeval import COCOeval

mode, n_dets, n_images = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
rng = np.random.default_rng(0)
cats = list(range(1, 81))

gt = COCO()
gt.dataset = {{
    "images": [{{"id": i, "width": 640, "height": 480}}
               for i in range(n_images)],
    "categories": [{{"id": c, "name": str(c)}} for c in cats],
    "annotations": [],
}}
anns = []
for i in range(n_images):
    for _ in range(7):
        w, h = rng.uniform(8, 300, 2)
        x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
        anns.append({{"id": len(anns) + 1, "image_id": i,
                     "category_id": int(rng.choice(cats)),
                     "bbox": [float(x), float(y), float(w), float(h)],
                     "area": float(w * h), "iscrowd": 0}})
gt.dataset["annotations"] = anns
gt.create_index()

img_id = rng.integers(0, n_images, n_dets).astype(np.int64)
cat_id = rng.integers(1, 81, n_dets).astype(np.int64)
w = rng.uniform(8, 300, n_dets); h = rng.uniform(8, 300, n_dets)
x = rng.uniform(0, 640 - w); y = rng.uniform(0, 480 - h)
bbox = np.stack([x, y, w, h], 1)
score = rng.uniform(1e-5, 1.0, n_dets)

t0 = time.time()
if mode == "dict":
    res = [{{"image_id": int(img_id[i]), "category_id": int(cat_id[i]),
            "bbox": bbox[i].tolist(), "score": float(score[i]),
            "segmentation": []}} for i in range(n_dets)]
else:
    res = {{"image_id": img_id, "category_id": cat_id,
           "bbox": bbox, "score": score}}
t_conv = time.time() - t0

t0 = time.time()
dt = gt.loadRes(res)
ev = COCOeval(gt, dt, "bbox")
ev.evaluate()
ev.accumulate()
with contextlib.redirect_stdout(io.StringIO()):
    ev.summarize()
t_eval = time.time() - t0

print(json.dumps({{
    "mode": mode, "n_dets": n_dets, "n_images": n_images,
    "ap": round(float(ev.stats[0]), 6),
    "convert_s": round(t_conv, 2), "eval_s": round(t_eval, 2),
    "peak_host_rss_gb": round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
}}))
"""


# `ru_maxrss` is carried across exec: a child started straight from a
# large process (`chip_smoke.py`) reads that process's peak as its own. A
# small launcher in between hands on only its own (~15 MB).
_LAUNCHER = ("import subprocess, sys; "
             "sys.exit(subprocess.run(sys.argv[1:]).returncode)")


def run(dets: int, images: int, timeout=None) -> list:
    """One child a mode; each mode's JSON record (or its error). With a
    `timeout` (s), a child still running then raises
    `subprocess.TimeoutExpired`."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = _CHILD.format(repo=repo)
    records = []
    for mode in ("columnar", "dict"):
        out = subprocess.run(
            [sys.executable, "-c", _LAUNCHER, sys.executable, "-c", child,
             mode, str(dets), str(images)],
            capture_output=True, text=True, timeout=timeout)
        line = (out.stdout.strip().splitlines() or ["{}"])[-1]
        if out.returncode != 0:
            line = json.dumps({"mode": mode, "error": out.stderr[-400:]})
        print(line, flush=True)
        records.append(json.loads(line))
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dets", type=int, default=5_120_000)
    ap.add_argument("--images", type=int, default=5_000)
    args = ap.parse_args(argv)
    return run(args.dets, args.images)


if __name__ == "__main__":
    main()
