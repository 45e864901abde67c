"""Helpers for the port's data-parallel tests (`tests/test_torch_parallel.py`,
`tests/test_torch_cli.py`): the tiny configs, the evaluation's fake models,
and the body of each gloo rank the tests spawn.

Nothing here imports JAX: the spawned ranks run the port alone, and the
parent test holds their results to the JAX package. A rank reads its
inputs from `<root>/inputs.pkl` and writes what it saw to
`<root>/rank<r>.pkl`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

NUM_CLASSES = 3
SIZE = 64
WORLD = 2
PER_RANK = 2    # images a rank takes of the global batch
# bounds on every wait, so that a hang fails the test by name within
# minutes: a gloo collective (the group's timeout) and the spawned ranks
# as a whole (`parallel.mesh.spawn_ranks`)
COLLECTIVE_TIMEOUT_S = 180
SPAWN_TIMEOUT_S = 480


def run_bounded(cmd, timeout, **kw):
    """Run `cmd` in a session of its own, output captured; at `timeout`
    seconds kill the session (the command and every process it started,
    spawned ranks included) and fail, naming `cmd`. Returns (returncode,
    output)."""
    import signal
    import subprocess

    proc = subprocess.Popen(cmd, start_new_session=True, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, **kw)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
        raise AssertionError(f"{cmd} did not end within {timeout} s:\n"
                             f"{out[-3000:]}") from None
    return proc.returncode, out


def sleeping_rank(rank, seconds):
    """A rank that sleeps `seconds[rank]` (`spawn_ranks`' tests)."""
    import time

    time.sleep(seconds[rank])


def tiny_config(cls, data_dir=None, out_dir=None):
    """yolox-s at depth 0.33, width 0.125, 3 classes, 64 px (`cls`: the
    port's or the JAX package's `YoloxConfig`), evaluating the synthetic
    set's train2017 images."""
    cfg = cls.get_named_config("yolox_s")
    cfg.depth, cfg.width, cfg.num_classes = 0.33, 0.125, NUM_CLASSES
    cfg.input_size = cfg.test_size = (SIZE, SIZE)
    cfg.lane_fold = False  # the JAX package's TPU layout; same math
    cfg.data_num_workers = 0
    if data_dir is not None:
        cfg.data_dir = data_dir
        cfg.train_ann = cfg.val_ann = "instances_train2017.json"
    if out_dir is not None:
        cfg.output_dir = out_dir
    return cfg


class JitteredGtModel:
    """Each image's ground truth, jittered, and seeded distractor boxes,
    as decoded anchors: a non-trivial AP that depends on every image's
    detections. `ids` is set per batch (chip_smoke's `IdsLoader`); numpy
    in, numpy out, torch in, torch out."""

    device = torch.device("cpu")

    def __init__(self, dataset, num_classes, anchors=32, size=SIZE):
        self.dataset, self.num_classes = dataset, num_classes
        self.anchors, self.size, self.ids = anchors, size, []

    def __call__(self, imgs):
        b, a, nc = imgs.shape[0], self.anchors, self.num_classes
        out = np.zeros((b, a, 5 + nc), np.float32)
        for i in range(b):
            rng = np.random.default_rng(self.ids[i])
            out[i, :, :2] = rng.uniform(4, self.size - 4, (a, 2))
            out[i, :, 2:4] = rng.uniform(4, self.size / 2, (a, 2))
            out[i, :, 4] = rng.uniform(0.2, 0.9, a)
            out[i, np.arange(a), 5 + rng.integers(0, nc, a)] = 0.9
            for k, (x1, y1, x2, y2, cls) in enumerate(
                    self.dataset.load_anno(self.ids[i])):
                out[i, k, :5] = [(x1 + x2) / 2 + rng.uniform(-2, 2),
                                 (y1 + y2) / 2, x2 - x1, y2 - y1, 0.95]
                out[i, k, 5:] = 0
                out[i, k, 5 + int(cls)] = 0.95
        return torch.from_numpy(out) if isinstance(imgs, torch.Tensor) \
            else out


def coco_dataset(coco_dir, pkg):
    """The synthetic COCO set's train2017 images at 64 px (`pkg` the port
    or the JAX package)."""
    return pkg.data.CocoDataset(
        data_dir=coco_dir, json_file="instances_train2017.json",
        name="train2017", img_size=(SIZE, SIZE),
        preproc=pkg.data.ValTransform())


def voc_dataset(voc_root, pkg):
    return pkg.data.VocDetection(
        voc_root, image_sets=[("2007", "trainval")], img_size=(SIZE, SIZE),
        preproc=pkg.data.ValTransform())


def evaluate(evaluator_cls, loader, num_classes, distributed=False):
    """`evaluator_cls` (a COCO or VOC evaluator of either package) over
    `loader` with a `JitteredGtModel`: (AP50:95, AP50, summary)."""
    from chip_smoke import IdsLoader

    model = JitteredGtModel(loader.dataset, num_classes)
    ev = evaluator_cls(dataloader=IdsLoader(loader, model),
                       img_size=(SIZE, SIZE), confthre=0.1, nmsthre=0.65,
                       num_classes=num_classes, max_det=32)
    if distributed:
        return ev.evaluate(model, distributed=True)
    return ev.evaluate(model)


def _threads(world):
    from tests._torch_threads import cpu_share

    torch.set_num_threads(max(1, cpu_share() // world))


def parallel_rank(rank, root):
    """One gloo rank of `test_torch_parallel`'s run: the train-step cases
    of `inputs.pkl` on this rank's half of the batch, the collectives, the
    training loader and the COCO and VOC evaluations."""
    import yolox_tpu_torch
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.core import init_train_state, make_train_step
    from yolox_tpu_torch.evaluators import CocoEvaluator, VocEvaluator
    from yolox_tpu_torch.models.weights import (
        train_state_from_jax,
        train_state_to_jax,
    )
    from yolox_tpu_torch.parallel import mesh

    _threads(WORLD)
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh.init_distributed("gloo", f"file://{root}/rendezvous", WORLD, rank,
                          timeout=COLLECTIVE_TIMEOUT_S)
    out = {"rank": rank}
    try:
        group = torch.distributed.group.WORLD
        mine = slice(rank * PER_RANK, (rank + 1) * PER_RANK)
        cfg = tiny_config(YoloxConfig, inp["coco_dir"])
        for name, start, kw in inp["cases"]:
            module = YoloxModule.from_config(cfg, device="cpu").double()
            state = init_train_state(module)
            train_state_from_jax(start, state)
            step = make_train_step(module, NUM_CLASSES,
                                   compute_dtype=torch.float64,
                                   group=group, **kw)
            state, losses = step(state, inp["x"][mine], inp["labels"][mine],
                                 0.01)
            out[name] = {"state": train_state_to_jax(state),
                         "losses": {k: float(v) for k, v in losses.items()},
                         "identical": mesh.ranks_identical(state)}

        out["gathered"] = mesh.all_gather_objects(
            {"rank": rank, "pid": os.getpid()})
        out["any_rank"] = (mesh.any_rank(rank == 1), mesh.any_rank(False))

        loader = cfg.get_data_loader(WORLD * PER_RANK, is_distributed=True)
        sampler = loader.batch_sampler
        batches = iter(sampler)
        out["loader"] = {
            "batch_size": sampler.batch_size,
            "rank": sampler.sampler.rank,
            "world": sampler.sampler.world_size,
            "batches": [next(batches) for _ in range(3)]}

        # a spawned process spawns its own children by default; the
        # loaders' workers fork
        from yolox_tpu_torch.data.dataloading import worker_context

        out["start_methods"] = (
            torch.multiprocessing.get_start_method(),
            yolox_tpu_torch.data.eval_loader(
                coco_dataset(inp["coco_dir"], yolox_tpu_torch), 4,
                num_workers=2).multiprocessing_context.get_start_method(),
            worker_context(2).get_start_method())
        try:
            cfg.get_eval_loader(WORLD * PER_RANK + 1, is_distributed=True)
        except ValueError as e:
            out["odd_batch"] = str(e)
        eval_loader = cfg.get_eval_loader(WORLD * PER_RANK,
                                          is_distributed=True)
        out["eval_ids"] = [int(i[0]) for b in eval_loader for i in b[3]]
        out["coco"] = evaluate(CocoEvaluator, eval_loader, NUM_CLASSES,
                               distributed=True)
        voc = voc_dataset(inp["voc_root"], yolox_tpu_torch)
        out["voc"] = evaluate(
            VocEvaluator, yolox_tpu_torch.data.eval_loader(
                voc, PER_RANK, rank=rank, world_size=WORLD), 20,
            distributed=True)
    finally:
        mesh.destroy_distributed()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
