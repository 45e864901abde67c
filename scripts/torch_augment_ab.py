"""Host-against-device augmentation A/B of the PyTorch port
(`yolox_tpu_torch`): the port's counterpart of `scripts/augment_ab.py`.

Trains the same tiny detection task twice through the port's `Trainer`:
once with the host augmentation pipeline (Mosaic/affine/HSV/flip in the
loader, `data/datasets/mosaicdetection.py`) and once with
`device_augment=True` (the on-device engine, `data/device_augment.py`;
on a CUDA card its warp runs bf16 products and the shear kernel K5), and
compares the training outcomes: the run-average and final loss, and
whether the trained EMA model makes confident, correctly classified,
correctly centred detections on the clean images. The distribution-level
check of the same two pipelines is `tests/test_torch_augment_equivalence.py`.

The dataset has real signal (coloured rectangles, `build_learnable_coco`
of `tests/_synthetic_coco.py`), so the task is learnable, not memorised.
Training runs PyTorch's deterministic algorithms, so on a card a seed
gives one result, as JAX's compiled steps do: with cuDNN's default
backward, two runs of one arm at one seed on an H100 gave run-average
losses of 7.37 and 9.07.

Usage:
    python scripts/torch_augment_ab.py [--epochs 50] [--which both|host|dev]
        [--device {cuda,cpu}]

Prints one `RESULT {json}` line an arm, with the JAX script's keys. On a
card it first prints `CARD <name>, <power limit>` (nvidia-smi) and after
each arm `RATE {json}`: the images trained, the wall seconds of
`Trainer.train` (evaluations and checkpoints included) and their ratio.
The card is the default; with no card and no `--device cpu` the script
exits non-zero.
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time
from argparse import Namespace

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO / "tests"))

from yolox_tpu_torch import YoloxConfig  # noqa: E402

BATCH = 4


class ABConfig(YoloxConfig):
    """Tiny 3-class config over the learnable synthetic set; geometry
    kept mild (no rotation/shear/mixup) so 50 epochs x 4 iterations
    converge (the JAX script's `ABConfig`, field for field)."""

    def __init__(self, data_dir, out_dir, dev, max_epoch):
        super().__init__("aug_ab_dev" if dev else "aug_ab_host")
        self.num_classes = 3
        self.depth, self.width = 0.33, 0.125
        self.input_size = self.test_size = (96, 96)
        self.max_epoch = max_epoch
        self.warmup_epochs = 2
        self.no_aug_epochs = max(2, max_epoch // 5)
        self.eval_interval = 10**6
        self.print_interval = 20
        self.data_num_workers = 0
        self.save_history_ckpt = False
        self.multiscale_range = 0
        self.enable_mixup = False
        self.mixup_prob = 0.0
        self.degrees = 0.0
        self.shear = 0.0
        self.mosaic_scale = (0.5, 1.5)
        self.basic_lr_per_img = 0.02 / 4
        self.device_augment = dev
        self.seed = 3
        self.data_dir = data_dir
        self.output_dir = out_dir

    def get_eval_dataset(self, **kw):
        from yolox_tpu_torch.data import CocoDataset, ValTransform

        return CocoDataset(
            data_dir=self.data_dir, json_file=self.train_ann,
            name="train2017", img_size=self.test_size,
            preproc=ValTransform())


def detect(cfg, module, data_dir, n=6, conf=0.1):
    """Clean-image detections of `module` on its device: per image, the
    top box's class / confidence / whether its centre falls inside the gt
    box."""
    import torch

    from yolox_tpu_torch.data.data_augment import ValTransform
    from yolox_tpu_torch.data.datasets.coco import read_bgr
    from yolox_tpu_torch.ops.nms import postprocess_device
    from yolox_tpu_torch.utils.model_utils import adjust_status

    vt = ValTransform()
    ann = json.load(open(pathlib.Path(data_dir)
                         / "annotations/instances_train2017.json"))
    cat_to_idx = {c["id"]: i for i, c in enumerate(
        sorted(ann["categories"], key=lambda c: c["id"]))}
    gt = {a["image_id"]: a for a in ann["annotations"]}
    device = next(module.parameters()).device
    out = []
    for im in ann["images"][:n]:
        img = read_bgr(str(pathlib.Path(data_dir) / "train2017"
                           / im["file_name"]))
        x, _ = vt(img, None, cfg.test_size)
        with adjust_status(module, training=False), torch.no_grad():
            dets, valid = postprocess_device(
                module(torch.from_numpy(x)[None].to(device)),
                cfg.num_classes, conf_thre=conf, nms_thre=0.65)
        d = dets[0].cpu().numpy()
        v = int(valid[0].sum())
        a = gt[im["id"]]
        gx, gy, gw, gh = a["bbox"]
        rec = {"img": im["id"], "n": v,
               "gt_cls": cat_to_idx[a["category_id"]]}
        if v:
            top = d[0]
            cx, cy = (top[0] + top[2]) / 2, (top[1] + top[3]) / 2
            rec.update(cls=int(top[6]), conf=float(top[4] * top[5]),
                       center_in_gt=bool(gx <= cx <= gx + gw
                                         and gy <= cy <= gy + gh))
        out.append(rec)
    return out


def images_trained(max_epoch: int, n_images: int = 16) -> int:
    """Images one arm trains on: every iteration of every epoch."""
    return max_epoch * (n_images // BATCH) * BATCH


def run_arm(dev: bool, data_dir: str, max_epoch: int, device=None) -> dict:
    import torch

    from torch_quant_accuracy import deterministic_algorithms

    out_dir = tempfile.mkdtemp(prefix=f"aug_ab_{dev}_")
    cfg = ABConfig(data_dir, out_dir, dev, max_epoch)
    args = Namespace(batch_size=BATCH, fp16=False, cache=None,
                     logger="tensorboard", ckpt=None, resume=False,
                     start_epoch=None, name=None, devices=1, device=device)
    t0 = time.time()
    trainer = cfg.get_trainer(args)
    with deterministic_algorithms():
        trainer.train()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    wall = time.time() - t0
    dets = detect(cfg, trainer._eval_module(), data_dir)
    good = [d for d in dets
            if d["n"] and d.get("cls") == d["gt_cls"]
            and d.get("conf", 0) > 0.3 and d.get("center_in_gt")]
    return {"dev": dev, "wall_s": round(wall, 1),
            "run_avg_loss": float(trainer.meter["total_loss"].global_avg),
            "final_loss": float(trainer.meter["total_loss"].avg),
            "confident_correct": len(good), "dets": dets}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--which", choices=["both", "host", "dev"],
                    default="both")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from yolox_tpu_torch.models.yolox import resolve_device

    device = resolve_device(args.device)  # no card and no "cpu": raises
    if device.type == "cuda":
        from torch_profile_serve import nvidia_smi

        print("CARD", nvidia_smi(), flush=True)

    # by file, not as `tests._synthetic_coco`: a host may have another
    # package named `tests` installed
    from _synthetic_coco import build_learnable_coco

    data_dir = build_learnable_coco(tempfile.mkdtemp(prefix="lcoco_"))
    arms = {"both": [False, True], "host": [False], "dev": [True]}
    results = []
    for dev in arms[args.which]:
        r = run_arm(dev, data_dir, args.epochs, device=str(device))
        print("RESULT", json.dumps(r), flush=True)
        if device.type == "cuda":
            n = images_trained(args.epochs)
            print("RATE", json.dumps({
                "dev": dev, "images": n, "wall_s": r["wall_s"],
                "img_s": round(n / max(r["wall_s"], 1e-9), 1)}), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
