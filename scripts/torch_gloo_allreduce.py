#!/usr/bin/env python3
"""The data-parallel step's all-reduce under gloo, two ranks sharing one
CUDA card: CUDA tensors handed to gloo as they are (gloo copies them
through pinned host memory itself), against the same bucket staged by
hand through a pinned host buffer kept across calls, and against the
port's `parallel/mesh.py::MeanReducer` (which hands gloo the CUDA
bucket; it also clones its inputs here, since it reduces in place).

    python3 scripts/torch_gloo_allreduce.py [--reps 9]

The bucket is what `core/train_step.py` hands the reducer for yolox-s:
one gradient a parameter, every BN layer's running mean and variance and
the seven logged losses (float32; seeded values, different on each rank).
Each rep runs the variants in turns (staged, direct, reducer, reducer,
direct, staged), each timed from a barrier with the card synchronised on
both sides. Checks that the three give the same bits and that both
ranks end with them. Prints one JSON line: the card's name and power
limit, the values in the bucket, each variant's times and median.
Exits non-zero without a CUDA device or if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

WORLD = 2


def bucket(rank):
    """The tensors one yolox-s step reduces, seeded by `rank`, on cuda:0."""
    import torch

    from yolox_tpu_torch import YoloxConfig, YoloxModule

    cfg = YoloxConfig.get_named_config("yolox_s")
    module = YoloxModule.from_config(cfg, rng_seed=4321, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(rank)
    grads = [torch.randn(p.shape, generator=gen, device="cuda")
             for p in module.parameters()]
    stats = [t.clone() + rank for m in module.modules()
             if isinstance(m, torch.nn.BatchNorm2d)
             for t in (m.running_mean, m.running_var)]
    losses = [torch.full((), float(rank + i), device="cuda")
              for i in range(7)]
    return grads + stats + losses


def direct(tensors, world, pinned):
    """One flattened all-reduce of the CUDA bucket: gloo stages it."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    return flat.div_(world)


def staged(tensors, world, pinned):
    """The same through a pinned host buffer kept across calls."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = pinned.get(flat.numel())
    if host is None:
        host = pinned[flat.numel()] = torch.empty(
            flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat)
    dist.all_reduce(host)
    flat.copy_(host)
    return flat.div_(world)


def reducer(tensors, world, pinned):
    """`MeanReducer` on copies (it reduces in place)."""
    import torch

    from yolox_tpu_torch.parallel.mesh import MeanReducer

    if "reducer" not in pinned:
        pinned["reducer"] = MeanReducer()
    copies = [t.clone() for t in tensors]
    pinned["reducer"](copies)
    return torch.cat([t.reshape(-1) for t in copies])


VARIANTS = {"staged": staged, "direct": direct, "reducer": reducer}
ORDER = ("staged", "direct", "reducer", "reducer", "direct", "staged")


def rank_main(rank, root, reps):
    import torch
    import torch.distributed as dist

    from yolox_tpu_torch.parallel import mesh

    mesh.init_distributed("gloo", f"file://{root}/rendezvous", WORLD, rank,
                          device="cuda:0")
    try:
        tensors = bucket(rank)
        pinned, times, results = {}, {k: [] for k in VARIANTS}, {}
        for name in VARIANTS:  # warm-up: buffers, gloo's pairs
            results[name] = VARIANTS[name](tensors, WORLD, pinned)
        for _ in range(reps):
            for name in ORDER:
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                VARIANTS[name](tensors, WORLD, pinned)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
        same = all(torch.equal(results["staged"], results[k])
                   for k in VARIANTS)
        ref = results["staged"].clone()
        dist.broadcast(ref, src=0)
        out = {"values": int(ref.numel()), "same_bits": same,
               "ranks_equal": not mesh.any_rank(
                   not torch.equal(ref, results["staged"])),
               "ms": times}
    finally:
        mesh.destroy_distributed()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=9)
    args = parser.parse_args()
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("torch_gloo_allreduce: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as root:
        mp.spawn(rank_main, args=(root, args.reps), nprocs=WORLD, join=True)
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    res = {"card": card, "ranks": WORLD, "values": ranks[0]["values"],
           "same_bits": [r["same_bits"] for r in ranks],
           "ranks_equal": ranks[0]["ranks_equal"],
           "median_ms": {k: [float(np.median(r["ms"][k])) for r in ranks]
                         for k in VARIANTS},
           "ms": {k: [r["ms"][k] for r in ranks] for k in VARIANTS}}
    print(json.dumps(res), flush=True)
    if not (all(res["same_bits"]) and res["ranks_equal"]):
        print("torch_gloo_allreduce: the variants or the ranks disagree",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
