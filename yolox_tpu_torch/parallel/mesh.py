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
- the preemption sync point -> `any_rank`, a flag all-reduced with MAX;
- the serving meshes -> `ServingMesh`: `data_parallel_mesh(n)` splits the
  batch over `data`, `serving_mesh(n_data, n_space)` also splits the image
  height over `space` (rank r = d * n_space + s, row-major as JAX's
  `reshape(n_data, n_space)` of the device list), each a set of process
  groups; `batch_sharding` / `image_sharding` say which images and rows a
  rank takes, `parallel/halo.py` exchanges the halos, and
  `YoloxModule.make_serving_fn(mesh=...)` runs the meshed call.

Backends: NCCL for one process per CUDA device, gloo on the CPU and for
several ranks that share one CUDA device (NCCL refuses two ranks on one
GPU). gloo takes CUDA tensors and copies them through pinned host memory
itself (`scripts/torch_gloo_allreduce.py`: as fast as staging the bucket
by hand).
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from yolox_tpu_torch.parallel.halo import (
    SpaceExchange,
    Transport,
    as_bytes,
    row_slabs,
)
from yolox_tpu_torch.utils.logger import logger


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


class ServingMesh:
    """A (`data`, `space`) serving mesh over the first n_data * n_space
    ranks of the default process group: rank r sits at (d, s) = (r //
    n_space, r % n_space). `space_group` holds this rank's row of the
    mesh (its d), `data_group` its column (its s); both None for a (1, 1)
    mesh without a process group, and `coords` None on a rank outside the
    mesh. `space` / `data` are the groups' `Transport`s."""

    def __init__(self, n_data: int, n_space: int = 1, rank: int = 0,
                 space_group=None, data_group=None, backend: str = "gloo"):
        if n_data < 1 or n_space < 1:
            raise ValueError(f"a serving mesh needs n_data, n_space >= 1, "
                             f"got ({n_data}, {n_space})")
        self.n_data, self.n_space, self.rank = n_data, n_space, rank
        self.space_group, self.data_group = space_group, data_group
        self.space = Transport(space_group, backend)
        self.data = Transport(data_group, backend)

    @property
    def size(self) -> int:
        return self.n_data * self.n_space

    @property
    def coords(self) -> Optional[Tuple[int, int]]:
        if self.rank >= self.size:
            return None
        return divmod(self.rank, self.n_space)

    def space_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this rank's `space` group, by s."""
        d = self.coords[0]
        return tuple(d * self.n_space + s for s in range(self.n_space))

    def __repr__(self):
        return (f"ServingMesh(n_data={self.n_data}, n_space={self.n_space}, "
                f"rank={self.rank}, coords={self.coords})")


def serving_mesh(n_data: int, n_space: int = 1) -> ServingMesh:
    """The (`data`, `space`) mesh over the first n_data * n_space ranks of
    the default process group (JAX's `serving_mesh`). Every rank of the
    default group calls it, since each of the mesh's groups is made by a
    collective `dist.new_group`; a rank past the mesh gets a mesh it
    cannot serve on. A (1, 1) mesh needs no process group."""
    rank, world = process_rank_and_count()
    mesh = ServingMesh(n_data, n_space, rank)
    if mesh.size > world:
        raise ValueError(f"a ({n_data}, {n_space}) serving mesh needs "
                         f"{mesh.size} ranks, the process group has {world}")
    if not is_distributed():
        return mesh
    backend = dist.get_backend()
    space = [dist.new_group([d * n_space + s for s in range(n_space)])
             for d in range(n_data)]
    data = [dist.new_group([d * n_space + s for d in range(n_data)])
            for s in range(n_space)]
    if mesh.coords is None:
        return ServingMesh(n_data, n_space, rank, backend=backend)
    d, s = mesh.coords
    mesh = ServingMesh(n_data, n_space, rank, space[d], data[s], backend)
    if backend == "nccl":
        # a collective first, so that later point-to-point calls from a
        # subset of the group find its communicator made
        for g in (mesh.space_group, mesh.data_group):
            dist.barrier(group=g, device_ids=[torch.cuda.current_device()])
    return mesh


def data_parallel_mesh(n: Optional[int] = None) -> ServingMesh:
    """A `data` mesh of n ranks (default: all of the process group's):
    the batch split, the image whole (JAX's `data_parallel_mesh`)."""
    return serving_mesh(n or process_count(), 1)


def _coords(mesh: ServingMesh) -> Tuple[int, int]:
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is outside the ({mesh.n_data}, "
                         f"{mesh.n_space}) serving mesh")
    return mesh.coords


def batch_sharding(mesh: ServingMesh, batch: int) -> slice:
    """This rank's images of a global batch of `batch`: batch / n_data of
    them by its `data` coordinate. A batch that does not divide raises,
    as JAX's sharding does."""
    d, _ = _coords(mesh)
    if batch % mesh.n_data:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{mesh.n_data} data ranks")
    per = batch // mesh.n_data
    return slice(d * per, (d + 1) * per)


class ImageShard(NamedTuple):
    """This rank's part of an NHWC batch: its `images`, its input `rows`
    (start, stop; empty where there are fewer stride rows than `space`
    ranks), every `space` rank's rows (`slabs`) and its own index among
    them: the halo plan (`halo.halo_moves`)."""

    images: slice
    rows: Tuple[int, int]
    slabs: Tuple[Tuple[int, int], ...]
    index: int


def image_sharding(mesh: ServingMesh, batch: int, height: int
                   ) -> ImageShard:
    """This rank's images, rows and halo plan of a (batch, height, W, 3)
    batch: images over `data` (`batch_sharding`), rows over `space`
    (`halo.row_slabs`: borders on multiples of the model's largest
    stride)."""
    images = batch_sharding(mesh, batch)
    _, s = _coords(mesh)
    slabs = row_slabs(height, mesh.n_space)
    return ImageShard(images, slabs[s], slabs, s)


def space_exchange(mesh: ServingMesh, shard: ImageShard
                   ) -> Optional[SpaceExchange]:
    """The halo exchange of `shard` over the mesh's `space` group; None
    without a `space` split."""
    if mesh.n_space == 1:
        return None
    return SpaceExchange(shard.slabs, shard.index, mesh.space_ranks(),
                         mesh.space)


def gather_batch(mesh: ServingMesh, *tensors: torch.Tensor):
    """Each tensor concatenated along dim 0 over the mesh's `data` group,
    in data-rank order (`tensors` equal in shape on every rank); as they
    are for a mesh without process groups."""
    if mesh.data_group is None:
        return tensors
    payload = torch.cat([as_bytes(t) for t in tensors])
    got = mesh.data.all_gather(payload, payload.numel())
    out, offset = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        part = got[:, offset:offset + n].clone().view(t.dtype)
        out.append(part.reshape((-1,) + tuple(t.shape[1:])))
        offset += n
    return tuple(out)


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
