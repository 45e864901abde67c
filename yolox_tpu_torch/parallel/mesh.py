"""Process groups and data-parallel collectives, the port's counterpart of
the JAX package's `yolox_tpu/parallel/mesh.py`.

JAX runs one process per host and its mesh spans every device; the port
runs one process per device (PyTorch's `torch.distributed`), so the mesh
is the default process group and its collectives are explicit calls
after the backward rather than `lax.pmean` inside the program:

- gradient mean over the ranks -> `MeanReducer` (one flattened all-reduce
  a step, then a division by the world size: `lax.pmean`'s psum / n);
- BN running statistics -> the same all-reduce over each rank's updated
  statistics (JAX pmeans its `BNCollector` updates);
- logged losses -> the same all-reduce (`pmean_floats(losses)`);
- rank 0 -> `process_index() == 0`;
- evaluation's detection gather -> `all_gather_objects`, ordered by rank;
- the preemption sync point -> `any_rank`, a flag all-reduced with MAX.

Backends: NCCL for one process per CUDA device, gloo on the CPU and for
several ranks that share one CUDA device (NCCL refuses two ranks on one
GPU). gloo takes CUDA tensors and copies them through pinned host memory
itself (`scripts/torch_gloo_allreduce.py`: as fast as staging the bucket
by hand).

The serving meshes of the JAX package (`serving_mesh`, `image_sharding`:
the batch and the image height split across devices) are not ported.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from yolox_tpu_torch.utils.logger import logger

_SERVING_MESH = ("serving meshes (the batch and the image height split "
                 "across devices) are not ported to yolox_tpu_torch yet "
                 "(ROADMAP.md: the serving meshes)")


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_rank_and_count():
    """(rank, world size) of the default process group when one is
    initialized, else (0, 1)."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    return process_rank_and_count()[0]


def process_count() -> int:
    return process_rank_and_count()[1]


def is_main_process() -> bool:
    return process_index() == 0


def default_backend(device) -> str:
    """NCCL for one process per CUDA device, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(backend: str, init_method: str, world_size: int,
                     rank: int, device=None,
                     timeout: Optional[float] = None) -> None:
    """Join the default process group: `backend` ("nccl" or "gloo") at
    `init_method` (`tcp://host:port` or `file://path`), as `rank` of
    `world_size`. A CUDA `device` becomes this process's current device
    (and NCCL's bound device). `timeout` in seconds (torch's default when
    None). `destroy_distributed` leaves it."""
    kw = {}
    if device is not None and torch.device(device).type == "cuda":
        device = torch.device(device)
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    logger.info(f"process group: {backend}, rank {rank} of {world_size}")


def destroy_distributed() -> None:
    if is_distributed():
        dist.destroy_process_group()


def _collective_device(group):
    """Where a small host value crosses the group: the current CUDA device
    for NCCL, the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when `flag` is True on any (a MAX all-reduce):
    the ranks' common preemption decision at an iteration boundary."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def all_gather_objects(obj, group=None) -> List:
    """A picklable object from every rank, as a list ordered by rank; [obj]
    without a process group."""
    if not is_distributed():
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class MeanReducer:
    """In-place mean over the ranks of `group` of a list of float tensors:
    one flattened all-reduce (a sum) per dtype, then a division by the
    world size, so every rank ends with the same bits."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)

    def __call__(self, tensors: Sequence[torch.Tensor]) -> None:
        by_dtype = {}
        for t in tensors:
            if not t.is_floating_point():
                raise TypeError(f"MeanReducer averages float tensors, got "
                                f"{t.dtype}")
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.world)
            offset = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def serving_mesh(n_data: int, n_space: int = 1):
    raise NotImplementedError(_SERVING_MESH)


def image_sharding(mesh):
    raise NotImplementedError(_SERVING_MESH)


def dryrun_data_parallel(n: int, size: int = 64, batch_per_rank: int = 2,
                         cfg=None):
    """One data-parallel training step of `cfg` (a `YoloxConfig`; default
    yolox-s at full depth and width) at `size` px, `batch_per_rank` images
    a rank, each rank its own, in `n` gloo processes on the CPU: the
    counterpart of the JAX package's `__graft_entry__.dryrun_multichip`.
    Each rank checks that the ranks end the step with the same parameters,
    momentum, EMA and BN statistics; returns each rank's {"total_loss",
    "gathered": all_gather_objects of its rank}."""
    import json

    import torch.multiprocessing as mp

    from yolox_tpu_torch.config import YoloxConfig

    if cfg is None:
        cfg = YoloxConfig.get_named_config("yolox_s")
    with tempfile.TemporaryDirectory() as root:
        threads = max(1, torch.get_num_threads() // n)
        mp.spawn(_dryrun_rank,
                 args=(n, root, cfg, size, batch_per_rank, threads),
                 nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def state_bytes(state) -> torch.Tensor:
    """Every tensor a `TrainState` holds (parameters and buffers, SGD
    momentum, the EMA's state dict) as one uint8 CPU tensor: equal bytes
    mean identical states."""
    parts = [t for t in state.module.state_dict().values()]
    opt = state.optimizer
    for p in state.module.parameters():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            parts.append(buf)
    if state.ema is not None:
        parts += list(state.ema.ema.state_dict().values())
    return torch.cat([t.detach().reshape(-1).cpu().contiguous()
                      .view(torch.uint8) for t in parts])


def ranks_identical(state, group=None) -> bool:
    """Whether every rank holds the same `TrainState` bytes as rank 0
    (rank 0's bytes broadcast; gloo or NCCL)."""
    mine = state_bytes(state)
    dev = _collective_device(group)
    ref = mine.to(dev).clone()
    dist.broadcast(ref, src=0, group=group)
    return not any_rank(not torch.equal(ref.cpu(), mine), group)


def _dryrun_rank(rank, n, root, cfg, size, batch_per_rank, threads):
    import json

    import numpy as np

    from yolox_tpu_torch.core.train_step import (
        init_train_state,
        make_train_step,
    )

    torch.set_num_threads(threads)  # the caller's threads, shared out
    init_distributed("gloo", f"file://{root}/rendezvous", n, rank)
    try:
        module = cfg.get_model(device="cpu")
        state = init_train_state(module)
        step = make_train_step(module, cfg.num_classes,
                               group=dist.group.WORLD)
        rng = np.random.default_rng(0)
        b = n * batch_per_rank
        x = rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32)
        labels = np.zeros((b, 10, 5), np.float32)
        labels[:, 0] = [1, size / 2, size / 2, size / 3, size / 3]
        mine = slice(rank * batch_per_rank, (rank + 1) * batch_per_rank)
        state, losses = step(state, x[mine], labels[mine], 0.01)
        total = float(losses["total_loss"])
        if not np.isfinite(total):
            raise FloatingPointError(f"rank {rank}: non-finite loss {total}")
        if not ranks_identical(state):
            raise AssertionError("the ranks' states differ after the step")
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump({"total_loss": total,
                       "gathered": all_gather_objects(rank)}, f)
    finally:
        destroy_distributed()
