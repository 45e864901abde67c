"""`yolox-tpu-torch train`, the port's counterpart of `yolox_tpu/cli/train.py`.

Same flag surface (-c/-b/--resume/--ckpt/-e/--fp16/--cache/-l/-D/--seed),
plus --device. `-d N` trains data-parallel in N processes on this machine,
one a device (every CUDA device by default; gloo processes with --device
cpu); `--num_machines`, `--machine_rank` and `--dist-url` (tcp://host:port
of machine 0) span machines, ranks `machine_rank * N + i`. `-b` is the
global batch. `-D fused_conv_bwd=True` runs the 1x1 convs' backward on K3
/ K4, `-D device_augment=True` the augmentation's shear on K5,
`-D remat=True` the forward's stages under activation checkpointing.
"""

from __future__ import annotations

import argparse
import random
import sys

from yolox_tpu_torch.cli.utils import (
    add_device_flag,
    launch,
    parse_model_config_opts,
    resolve_config,
)
from yolox_tpu_torch.config import validate_config
from yolox_tpu_torch.utils.logger import logger


def make_parser():
    parser = argparse.ArgumentParser("yolox-tpu-torch train")
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="experiment/run name (default: model name)")
    parser.add_argument("-c", "--config", type=str, default=None,
                        required=True,
                        help="named model config (e.g. yolox-s) or "
                             "module:ClassName")
    parser.add_argument("-b", "--batch-size", type=int, default=64,
                        help="global batch size across all processes")
    parser.add_argument("-d", "--devices", type=int, default=None,
                        help="processes on this machine, one a device "
                             "(default: every local CUDA device)")
    parser.add_argument("--num_machines", type=int, default=1,
                        help="number of machines")
    parser.add_argument("--machine_rank", type=int, default=0,
                        help="this machine's rank")
    parser.add_argument("--dist-url", type=str, default=None,
                        help="rendezvous address of the process group "
                             "(tcp://host:port); a free local port when "
                             "one machine runs several processes")
    parser.add_argument("--resume", action="store_true",
                        help="resume from latest checkpoint")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint to resume from / warm-start with")
    parser.add_argument("-e", "--start_epoch", type=int, default=None,
                        help="resume start epoch")
    parser.add_argument("--fp16", dest="fp16", action="store_true",
                        help="mixed precision training (bf16)")
    parser.add_argument("--cache", type=str, nargs="?", const="ram",
                        default=None, choices=["ram", "disk"],
                        help="cache images to RAM or disk")
    parser.add_argument("-o", "--occupy", action="store_true",
                        help="kept for flag parity; no effect")
    parser.add_argument("-l", "--logger", type=str, default="tensorboard",
                        choices=["tensorboard", "mlflow", "wandb"],
                        help="experiment tracker")
    parser.add_argument("-D", dest="opts", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override a config option")
    parser.add_argument("--seed", type=int, default=None)
    add_device_flag(parser)
    return parser


def train(config, args):
    import numpy as np
    import torch

    from yolox_tpu_torch.utils.setup_env import (
        configure_module,
        configure_omp,
    )

    # tame the workers' thread pools, raise the fd limit (the JAX
    # package's XLA compile cache has no counterpart: nothing compiles)
    configure_omp()
    configure_module()

    if config.seed is not None:
        random.seed(config.seed)
        np.random.seed(config.seed)
        torch.manual_seed(config.seed)
        logger.warning(
            "You have chosen to seed training. Note that augmentation "
            "seeding is deterministic per (seed, sample) by design; full "
            "run determinism additionally requires deterministic cuDNN "
            "algorithms.")
    trainer = config.get_trainer(args)
    trainer.train()
    return trainer


def main(argv=None) -> int:
    launch(run, make_parser().parse_args(argv))
    return 0


def run(args):
    """The command in one process (a rank, under `launch`)."""
    config = resolve_config(args.config)
    config.update(parse_model_config_opts(args.opts))
    if args.seed is not None:
        config.seed = args.seed
    validate_config(config)
    if args.name is None:
        args.name = config.name

    if getattr(args, "cache", None) is not None:
        # build the cached dataset before the loader's workers fork, so
        # they share the cache
        config.dataset = config.get_dataset(cache=True,
                                            cache_type=args.cache)

    return train(config, args)


if __name__ == "__main__":
    sys.exit(main())
