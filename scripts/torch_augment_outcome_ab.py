#!/usr/bin/env python
"""Device-augment against host-augment training-outcome A/B of the
PyTorch port (`yolox_tpu_torch`): the port's counterpart of
`scripts/augment_outcome_ab.py`.

Two full `Trainer` runs on the same tiny synthetic COCO set
(`build_synthetic_coco` of `tests/_synthetic_coco.py`): one with the host
pipeline (MosaicDetection, affine, HSV and flip in the loader), one with
`device_augment=True` (mosaic/affine/mixup/HSV/flip on the device; on a
CUDA card the warp's bf16 products and the shear kernel K5). Then the
same COCO-mAP evaluation of both final EMA checkpoints (`latest_ckpt.pth`)
on the training images. The mAP and loss deltas are the recorded
outcome gap. Training runs PyTorch's deterministic algorithms, so on a
card a seed gives one result (`torch_augment_ab.py`). The distribution-level
check of the two pipelines is `tests/test_torch_augment_equivalence.py`.

Usage:  python scripts/torch_augment_outcome_ab.py [--epochs 150]
            [--out $TMPDIR/aug_ab] [--device {cuda,cpu}]

Prints `AUG_OUTCOME_AB {json}` with the JAX script's keys, on a card
after `CARD <name>, <power limit>` (nvidia-smi). The card is
the default; with no card and no `--device cpu` the script exits
non-zero. The default `--out` is `aug_ab` in the temporary directory
(`/tmp/aug_ab`, the JAX script's, when TMPDIR is unset).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 4


def make_config(data_dir: str, out_dir: str, epochs: int, device_aug: bool):
    from yolox_tpu_torch import YoloxConfig

    class AbConfig(YoloxConfig):
        def __init__(self):
            super().__init__(
                "aug_ab_" + ("device" if device_aug else "host"))
            self.num_classes = 3
            self.depth, self.width = 0.33, 0.125
            self.input_size = self.test_size = (64, 64)
            self.max_epoch = epochs
            self.warmup_epochs = 2
            self.no_aug_epochs = max(epochs // 10, 1)
            self.eval_interval = 10_000     # evaluate once, at the end
            self.print_interval = 50
            self.data_num_workers = 0
            self.save_history_ckpt = False
            self.multiscale_range = 0
            self.test_conf = 0.05
            self.device_augment = device_aug
            self.data_dir = data_dir
            self.output_dir = out_dir

        def get_eval_dataset(self, **kwargs):
            from yolox_tpu_torch.data import CocoDataset, ValTransform

            return CocoDataset(
                data_dir=self.data_dir, json_file=self.train_ann,
                name="train2017", img_size=self.test_size,
                preproc=ValTransform())

    return AbConfig()


def evaluate_checkpoint(cfg, path: str, device=None):
    """(AP50:95, AP50) of the checkpoint at `path` on the config's
    evaluation set, through a fresh module on `device`."""
    from yolox_tpu_torch.models.yolox import YoloxModule
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(path)
    module = YoloxModule.from_config(cfg, device=device)
    module.load_params(ckpt["model"])
    evaluator = cfg.get_evaluator(batch_size=BATCH)
    ap50_95, ap50, _summary = evaluator.evaluate(module, distributed=False)
    return ap50_95, ap50


def run_one(data_dir: str, out_dir: str, epochs: int, device_aug: bool,
            device=None):
    import numpy as np

    from torch_quant_accuracy import deterministic_algorithms

    cfg = make_config(data_dir, out_dir, epochs, device_aug)
    args = SimpleNamespace(batch_size=BATCH, fp16=False, cache=None,
                           logger="tensorboard", ckpt=None, resume=False,
                           start_epoch=None, name=cfg.name, device=device)
    trainer = cfg.get_trainer(args)
    with deterministic_algorithms():
        trainer.train()
    final_loss = float(np.asarray(trainer.meter["total_loss"].latest))

    # evaluate the saved (EMA) checkpoint on the training images
    ap50_95, ap50 = evaluate_checkpoint(
        cfg, os.path.join(out_dir, cfg.name, "latest_ckpt.pth"),
        device=trainer.device)
    return {
        "device_augment": device_aug,
        "final_loss": round(final_loss, 4),
        "ap50_95": round(float(ap50_95), 4),
        "ap50": round(float(ap50), 4),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "aug_ab"))
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from yolox_tpu_torch.models.yolox import resolve_device

    device = str(resolve_device(args.device))  # no card, no "cpu": raises
    if device == "cuda":
        from torch_profile_serve import nvidia_smi

        print("CARD", nvidia_smi(), flush=True)
    from _synthetic_coco import build_synthetic_coco

    root = pathlib.Path(args.out)
    root.mkdir(parents=True, exist_ok=True)
    data_dir = build_synthetic_coco(root / "data")

    host = run_one(data_dir, str(root), args.epochs, device_aug=False,
                   device=device)
    dev = run_one(data_dir, str(root), args.epochs, device_aug=True,
                  device=device)
    report = {
        "epochs": args.epochs,
        "host": host,
        "device": dev,
        "ap50_delta": round(dev["ap50"] - host["ap50"], 4),
        "ap50_95_delta": round(dev["ap50_95"] - host["ap50_95"], 4),
    }
    print("AUG_OUTCOME_AB " + json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
