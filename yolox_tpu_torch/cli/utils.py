"""CLI helpers, the port's copy of the JAX package's `yolox_tpu/cli/utils.py`.

`resolve_config`: a named config (hyphen/underscore tolerant) or a
`module:ClassName` path to a user subclass of the port's `YoloxConfig`.
`parse_model_config_opts`: `-D key=value` pairs -> dict.
`add_device_flag`: the port's `--device` flag. `launch`: run a command
in every process of a data-parallel run (`-d`, `--num_machines`,
`--machine_rank`, `--dist-url`).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, NamedTuple, Optional

from yolox_tpu_torch.config import YoloxConfig


def resolve_config(name: str) -> YoloxConfig:
    config = YoloxConfig.get_named_config(name)
    if config is not None:
        return config
    if ":" in name:
        module_name, class_name = name.rsplit(":", 1)
        module = importlib.import_module(module_name)
        cls = getattr(module, class_name, None)
        if cls is None or not (isinstance(cls, type)
                               and issubclass(cls, YoloxConfig)):
            raise ValueError(
                f"{name} is not a YoloxConfig subclass")
        return cls()
    raise ValueError(f"Unknown model config: {name}")


def parse_model_config_opts(opts: Optional[List[str]]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for opt in opts or []:
        if "=" not in opt:
            raise ValueError(
                f"Invalid -D option {opt!r}; expected key=value")
        k, v = opt.split("=", 1)
        out[k] = v
    return out


def add_device_flag(parser) -> None:
    """`--device {cuda,cpu}`: the CUDA card unless the CPU is asked for;
    with no card and no flag the command raises."""
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="device to run on (default: the CUDA card; "
                             "cpu runs the kernels' plain versions)")


def local_processes(args) -> int:
    """`-d`: the processes of this machine, one a device; by default every
    local CUDA device (one process on the CPU, or where there is none:
    the command then finds no device and says so). On CUDA, more than
    the machine has raises; on the CPU any number of gloo processes
    run."""
    import torch

    n = args.devices
    if getattr(args, "device", None) == "cpu":
        return n or 1
    have = torch.cuda.device_count()
    if n is None:
        return max(have, 1)
    if n > have:
        raise ValueError(
            f"-d {n}: this machine has {have} CUDA device(s); run at most "
            f"{have} processes, or --device cpu for gloo processes on the CPU")
    return n


class LaunchPlan(NamedTuple):
    nprocs: int        # processes started on this machine
    world_size: int
    first_rank: int    # the rank of this machine's first process
    backend: Optional[str]   # None: one process, no process group
    dist_url: Optional[str]


def launch_plan(args) -> LaunchPlan:
    """What `launch` runs: `-d` processes here with ranks machine_rank * d
    + i of d * num_machines; NCCL on CUDA, gloo with `--device cpu`. One
    process and no `--dist-url` makes no process group; one machine and no
    `--dist-url` rendezvous at a free local port."""
    from yolox_tpu_torch.parallel.mesh import default_backend, free_port

    n = local_processes(args)
    world = n * args.num_machines
    if not 0 <= args.machine_rank < args.num_machines:
        raise ValueError(f"--machine_rank {args.machine_rank} is outside "
                         f"the {args.num_machines} machine(s)")
    if world == 1 and args.dist_url is None:
        return LaunchPlan(1, 1, 0, None, None)
    url = args.dist_url
    if url is None:
        if args.num_machines > 1:
            raise ValueError("--num_machines > 1 needs --dist-url "
                             "(tcp://host:port of machine 0)")
        url = f"tcp://127.0.0.1:{free_port()}"
    backend = default_backend(getattr(args, "device", None) or "cuda")
    return LaunchPlan(n, world, args.machine_rank * n, backend, url)


def launch(fn, args) -> None:
    """fn(args) in every process of this machine's share of the run
    (`launch_plan`): in this process when it is the only one, else in
    `nprocs` spawned processes, each of which joins the process group
    (its CUDA device is the i-th local one), waits for the other ranks and
    leaves the group when fn returns. A process that fails makes this
    raise. fn must be importable (it is pickled by name)."""
    plan = launch_plan(args)
    if plan.backend is None:
        fn(args)
    elif plan.nprocs == 1:
        _run_rank(0, fn, args, plan)
    else:
        import torch.multiprocessing as mp

        mp.start_processes(_run_rank, args=(fn, args, plan),
                           nprocs=plan.nprocs, join=True,
                           start_method="spawn")


def _run_rank(local_rank, fn, args, plan: LaunchPlan) -> None:
    import torch.distributed as dist

    from yolox_tpu_torch.parallel.mesh import (
        destroy_distributed,
        init_distributed,
    )

    device = ("cpu" if plan.backend == "gloo"
              else f"cuda:{local_rank}")
    init_distributed(plan.backend, plan.dist_url, plan.world_size,
                     plan.first_rank + local_rank, device=device)
    try:
        dist.barrier()  # every rank is up (JAX's sync_global_devices)
        fn(args)
    finally:
        destroy_distributed()
