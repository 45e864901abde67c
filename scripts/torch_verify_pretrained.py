#!/usr/bin/env python
"""The pretrained-weight parity gate of the PyTorch port
(`yolox_tpu_torch`): the port's counterpart of
`scripts/verify_pretrained.py`, with the same legs, flags, tolerances,
`PARITY.json` layout and exit codes, plus `--device`.

The port's headline claim (upstream `.pth` checkpoints load and
reproduce the reference's detections and COCO mAP) is evidence only when
this script runs green. It settles the claim once the weights (and
COCO val2017 for the mAP leg) are at hand:

  python scripts/torch_verify_pretrained.py              # all 6 models
  python scripts/torch_verify_pretrained.py --models yolox_s yolox_tiny
  python scripts/torch_verify_pretrained.py --data-dir /datasets/COCO

Per model, three legs, on the card unless `--device cpu`:

  1. **golden detections**: the reference's own oracle (its
     `tests/test_detections.py`): three COCO images through
     `Yolox.from_pretrained` at threshold 0.5, labels exactly, scores
     within 1e-4, boxes within 1e-2. `--expectations FILE` replaces the
     reference's table with a JSON file of the same shape (as the tests
     do with random-weight fixtures).
  2. **COCO-val mAP**: val2017 through the port's `CocoEvaluator` against
     the upstream model-zoo table; |delta| > 0.1 mAP fails. "not-run"
     without a data dir holding annotations. `--int8` adds a leg for the
     int8 PTQ forward (calibrated on the first val batches) at
     `--int8-tol`.
  3. **train parity**: N seeded SGD steps of the port's `make_train_step`
     from the checkpoint against the reference's torch trainer on the
     same synthetic batches (float32 both sides); "not-run" when the
     reference tree does not import.

Every leg reads one upstream tree: `$YOLOX_REFERENCE`, else the one the
repository's reference oracle (`tests/_reference_oracle.py`) loads, as
for the JAX package's gate. It is read only when a leg needs it.

Exit status: 0 every leg that ran passed; 1 a leg failed; 2 weights or
oracle inputs missing (the gate cannot attest parity without evidence).
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


MODELS = ["yolox_nano", "yolox_tiny", "yolox_s", "yolox_m", "yolox_l",
          "yolox_x"]

# upstream model zoo, mAP val 0.5:0.95 (its docs/model_zoo.md: the
# standard models at 640, the light ones at 416)
ZOO_MAP = {
    "yolox_nano": 25.8,
    "yolox_tiny": 32.8,
    "yolox_s": 40.5,
    "yolox_m": 46.9,
    "yolox_l": 49.7,
    "yolox_x": 51.1,
}

BOX_ATOL = 1e-2
SCORE_ATOL = 1e-4
MAP_TOL = 0.1


def reference_tree():
    """The upstream YOLOX checkout (its golden images, expectations and
    trainer): `$YOLOX_REFERENCE`, else the reference oracle's tree; None
    when neither is known."""
    if os.environ.get("YOLOX_REFERENCE"):
        return Path(os.environ["YOLOX_REFERENCE"])
    try:
        from tests._reference_oracle import REFERENCE_PATH
    except ImportError:
        return None
    return REFERENCE_PATH


def default_images(reference):
    """The reference's golden images (none without a tree)."""
    if reference is None:
        return []
    return sorted(glob.glob(str(Path(reference) / "tests/data/*.jpg")))


def load_reference_expectations(reference):
    if reference is None:
        return None
    path = Path(reference) / "tests" / "test_detections.py"
    if not path.exists():
        return None
    # the reference test module imports its own `yolox` package at module
    # scope
    sys.path.insert(0, str(reference))
    try:
        spec = importlib.util.spec_from_file_location(
            "_ref_detections", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.DETECTIONS_DATA
    except Exception as e:
        print(f"reference expectations unavailable ({e}); pass "
              "--expectations FILE", file=sys.stderr)
        return None
    finally:
        sys.path.remove(str(reference))


def check_goldens(model_name, ckpt_path, expectations, images, device=None):
    """Leg 1: the golden detections; returns a result dict."""
    from PIL import Image

    from yolox_tpu_torch import Yolox, YoloxConfig

    config = YoloxConfig.get_named_config(model_name)
    model = Yolox.from_pretrained(str(ckpt_path), config=config,
                                  device=device)
    if len(images) != len(expectations):
        # never attest more coverage than was compared: zip() below would
        # drop the extra rows
        return {
            "status": "fail",
            "detail": f"{len(images)} images for "
                      f"{len(expectations)} expectation rows",
        }
    results = model([Image.open(p) for p in images], threshold=0.5)

    max_box = 0.0
    max_score = 0.0
    for i, (result, expected) in enumerate(zip(results, expectations)):
        if list(result["labels"]) != list(expected["labels"]):
            return {
                "status": "fail",
                "detail": f"image {i}: labels {list(result['labels'])} "
                          f"!= expected {list(expected['labels'])}",
            }
        if expected["labels"]:
            max_score = max(max_score, float(np.abs(
                np.asarray(result["scores"])
                - np.asarray(expected["scores"])).max()))
            max_box = max(max_box, float(np.abs(
                np.asarray(result["bboxes"], np.float64)
                - np.asarray(expected["bboxes"], np.float64)).max()))
    ok = max_box <= BOX_ATOL and max_score <= SCORE_ATOL
    return {
        "status": "pass" if ok else "fail",
        "max_box_err": max_box,
        "max_score_err": max_score,
        "tolerances": {"boxes": BOX_ATOL, "scores": SCORE_ATOL},
        "images": len(expectations),
    }


def check_map(model_name, ckpt_path, data_dir, int8=False,
              int8_tol=1.0, calib_batches=8, device=None):
    """Leg 2: COCO val2017 through `CocoEvaluator` against the model-zoo
    number, in bf16; with `int8` the int8 PTQ forward of a float32
    module instead, its activation scales calibrated on the first
    `calib_batches` val batches, at the wider `int8_tol`."""
    import itertools as it

    import torch

    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.models.weights import load_pth_state_dict

    config = YoloxConfig.get_named_config(model_name)
    config.data_dir = str(data_dir)
    dtype = torch.float32 if int8 else torch.bfloat16
    module = YoloxModule.from_config(config, dtype=dtype, device=device)
    module.load_params(load_pth_state_dict(str(ckpt_path)))
    evaluator = config.get_evaluator(batch_size=64)
    if int8:
        batches = (imgs for imgs, *_ in
                   it.islice(iter(evaluator.dataloader), calib_batches))
        module.enable_int8(module.calibrate_int8(batches))
    ap50_95, _ap50, _summary = evaluator.evaluate(
        module, distributed=False, half=not int8)
    measured = float(ap50_95) * 100.0
    expected = ZOO_MAP[model_name]
    delta = measured - expected
    tol = int8_tol if int8 else MAP_TOL
    return {
        "status": "pass" if abs(delta) <= tol else "fail",
        "expected_map": expected,
        "measured_map": round(measured, 3),
        "delta": round(delta, 3),
        "tolerance": tol,
    }


def _synthetic_train_batches(steps, batch, size, num_classes, seed=0):
    """Seeded (images, labels) batches fed to both trainers."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        x = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
        labels = np.zeros((batch, 10, 5), np.float32)
        for b in range(batch):
            for j in range(int(rng.integers(2, 5))):
                w = float(rng.uniform(32, size / 2))
                h = float(rng.uniform(32, size / 2))
                cx = float(rng.uniform(w / 2, size - w / 2))
                cy = float(rng.uniform(h / 2, size - h / 2))
                labels[b, j] = (float(rng.integers(num_classes)),
                                cx, cy, w, h)
        batches.append((x, labels))
    return batches


def check_train_parity(model_name, ckpt_path, steps=6, batch=2, size=320,
                       lr=0.01, tol=0.02, device=None, reference=None):
    """Leg 3: N seeded SGD steps from the checkpoint against the
    reference's torch trainer on the same batches: the per-step relative
    total-loss difference (the reference's `yolox/core/trainer.py`
    semantics without AMP: float32 on both sides, SGD nesterov momentum
    0.9, weight decay 5e-4 on the conv weights, train-mode BN).

    Needs the reference tree `reference` (default: `reference_tree()`),
    loaded by `tests/_reference_oracle.py`; "not-run" without it."""
    try:
        import tests._reference_oracle as oracle
    except ImportError:
        return {"status": "not-run", "detail": "tests package unavailable"}
    # the oracle loads the tree the other legs read
    oracle.REFERENCE_PATH = Path(reference or reference_tree())
    if not oracle.reference_available():
        return {"status": "not-run", "detail": "reference tree missing"}
    try:
        oracle.load_reference()
        import torch
    except Exception as e:  # the reference's own import failing
        return {"status": "not-run", "detail": f"oracle unavailable: {e}"}

    from yolox.config import YoloxConfig as RefConfig

    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.core.train_step import (
        init_train_state,
        make_train_step,
    )
    from yolox_tpu_torch.models.weights import load_pth_state_dict

    config = YoloxConfig.get_named_config(model_name)
    batches = _synthetic_train_batches(steps, batch, size,
                                       config.num_classes)

    # --- the port: its train step (float32, no EMA) ---
    module = YoloxModule.from_config(config, device=device)
    module.load_params(load_pth_state_dict(str(ckpt_path)))
    step = make_train_step(module, config.num_classes,
                           compute_dtype=torch.float32, use_ema=False)
    state = init_train_state(module, use_ema=False)
    ours = []
    for x, labels in batches:
        state, metrics = step(state, x, labels, lr)
        ours.append(float(metrics["total_loss"]))

    # --- the reference: its torch model and optimizer ---
    ref_cfg = RefConfig.get_named_config(model_name)
    ref_model = ref_cfg.get_model()
    ref_model.load_state_dict(
        torch.load(str(ckpt_path), map_location="cpu",
                   weights_only=False)["model"])
    ref_model.train()
    ref_cfg.basic_lr_per_img = lr / (batch * 64 / 64)  # exact lr below
    optimizer = ref_cfg.get_optimizer(batch)
    for g in optimizer.param_groups:
        g["lr"] = lr
    theirs = []
    for x, labels in batches:
        inps = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        targets = torch.from_numpy(labels)
        outputs = ref_model(inps, targets)
        loss = outputs["total_loss"]
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        theirs.append(float(loss.detach()))

    rel = [abs(a - b) / max(abs(b), 1e-9) for a, b in zip(ours, theirs)]
    # The first step (identical weights) must agree tightly: it pins the
    # losses and the assignment. Later steps are held by their median:
    # SimOTA's dynamic k can flip on a float32 near-tie at one step and
    # re-converge, so a real drift shows as a growing median and a flip
    # as one outlier.
    first_ok = rel[0] <= tol / 2
    median = float(np.median(rel))
    return {
        "status": "pass" if (first_ok and median <= tol) else "fail",
        "steps": steps,
        "loss_ours": [round(v, 5) for v in ours],
        "loss_reference": [round(v, 5) for v in theirs],
        "rel_diff_per_step": [round(r, 5) for r in rel],
        "first_rel_diff": round(rel[0], 5),
        "median_rel_diff": round(median, 5),
        "max_rel_diff": round(max(rel), 5),
        "tolerance": tol,
    }


def resolve_weights(model_name, weights_dir):
    """`<weights_dir>/<model>.pth` first; else the package's cached
    download (`YoloxModule._cached_pretrained_weights`)."""
    if weights_dir is not None:
        local = Path(weights_dir) / f"{model_name}.pth"
        if local.exists():
            return str(local)
    from yolox_tpu_torch.models.yolox import YoloxModule

    try:
        return YoloxModule._cached_pretrained_weights(model_name)
    except RuntimeError as e:
        print(f"[{model_name}] weights unavailable: {e}", file=sys.stderr)
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="pretrained-weight parity gate (see module docstring)")
    ap.add_argument("--models", nargs="+", default=MODELS,
                    choices=MODELS)
    ap.add_argument("--weights-dir", default=None,
                    help="directory of <model>.pth files; falls back to "
                         "the package cache (downloading when possible)")
    ap.add_argument("--expectations", default=None,
                    help="JSON golden-detection expectations "
                         "{model: [{labels, scores, bboxes}, ...]}; "
                         "default: the reference test module's table")
    ap.add_argument("--images", nargs="+", default=None,
                    help="golden test images (default: the reference's)")
    ap.add_argument("--data-dir", default=os.environ.get("YOLOX_DATADIR"),
                    help="COCO root with val2017 + annotations; omitting "
                         "skips the mAP leg")
    ap.add_argument("--skip-goldens", action="store_true")
    ap.add_argument("--skip-map", action="store_true")
    ap.add_argument("--skip-train", action="store_true",
                    help="skip leg 3 (train-parity: N seeded SGD steps vs "
                         "the reference torch trainer on identical "
                         "batches)")
    ap.add_argument("--train-steps", type=int, default=6)
    ap.add_argument("--train-tol", type=float, default=0.02,
                    help="max per-step relative total-loss difference")
    ap.add_argument("--int8", action="store_true",
                    help="also measure int8-PTQ mAP per model (extra "
                         "'map_int8' leg; gate tolerance --int8-tol)")
    ap.add_argument("--int8-tol", type=float, default=1.0,
                    help="max |mAP delta| vs the float zoo number for "
                         "the int8 leg (default 1.0)")
    ap.add_argument("--out", default="PARITY.json")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from yolox_tpu_torch.models.yolox import resolve_device

    device = resolve_device(args.device)
    reference = reference_tree()
    images, expectations_all = args.images, None
    if not args.skip_goldens:
        if images is None:
            images = default_images(reference)
        if args.expectations:
            with open(args.expectations) as f:
                expectations_all = json.load(f)
        else:
            expectations_all = load_reference_expectations(reference)

    map_available = (not args.skip_map and args.data_dir
                     and Path(args.data_dir, "annotations").exists())
    if not args.skip_map and not map_available:
        print("mAP leg: no COCO annotations found -> not-run",
              file=sys.stderr)

    report = {"tolerances": {"boxes": BOX_ATOL, "scores": SCORE_ATOL,
                             "map": MAP_TOL},
              "models": {}}
    exit_code = 0
    for model_name in args.models:
        entry = {}
        report["models"][model_name] = entry
        ckpt = resolve_weights(model_name, args.weights_dir)
        if ckpt is None:
            entry["weights"] = "missing"
            exit_code = max(exit_code, 2)
            continue
        entry["weights"] = ckpt

        if not args.skip_goldens:
            exp = (expectations_all or {}).get(model_name)
            if exp is None or not images:
                entry["goldens"] = {"status": "missing-oracle"}
                exit_code = max(exit_code, 2)
            else:
                entry["goldens"] = check_goldens(
                    model_name, ckpt, exp, images, device)
                if entry["goldens"]["status"] != "pass":
                    exit_code = max(exit_code, 1)

        if not args.skip_train:
            entry["train"] = check_train_parity(
                model_name, ckpt, steps=args.train_steps,
                tol=args.train_tol, device=device, reference=reference)
            if entry["train"]["status"] == "fail":
                exit_code = max(exit_code, 1)
            elif entry["train"]["status"] == "not-run":
                exit_code = max(exit_code, 2)

        if args.skip_map:
            pass
        elif not map_available:
            entry["map"] = {"status": "not-run",
                            "expected_map": ZOO_MAP[model_name]}
            exit_code = max(exit_code, 2)
        else:
            entry["map"] = check_map(model_name, ckpt, args.data_dir,
                                     device=device)
            if entry["map"]["status"] != "pass":
                exit_code = max(exit_code, 1)
            if args.int8:
                entry["map_int8"] = check_map(
                    model_name, ckpt, args.data_dir, int8=True,
                    int8_tol=args.int8_tol, device=device)
                if entry["map_int8"]["status"] != "pass":
                    exit_code = max(exit_code, 1)

        print(f"[{model_name}] " + json.dumps(entry))

    report["verdict"] = {0: "parity-verified", 1: "PARITY-FAILED",
                         2: "incomplete-evidence"}[exit_code]
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"{report['verdict']} -> {args.out}")
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
