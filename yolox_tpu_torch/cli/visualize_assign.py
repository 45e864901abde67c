"""`yolox-tpu-torch visualize-assign`, the port's counterpart of
`yolox_tpu/cli/visualize_assign.py`: draw SimOTA label-assignment results
for a few training batches.

Builds the training data pipeline of a config, runs the assignment on the
first `--max-batch` batches (`YoloxModule.visualize`, on the module's
device) and saves one annotated PNG per image: the ground-truth boxes and
a dot on every anchor SimOTA assigned to them. Drawing needs cv2.
"""

from __future__ import annotations

import argparse
import os
import sys

from yolox_tpu_torch.cli.utils import (
    add_device_flag,
    parse_model_config_opts,
    resolve_config,
)
from yolox_tpu_torch.utils.logger import logger, setup_logger


def make_parser():
    parser = argparse.ArgumentParser("yolox-tpu-torch visualize-assign")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint (default: random init)")
    parser.add_argument("--max-batch", type=int, default=1,
                        help="number of batches to visualize")
    parser.add_argument("--output-dir", type=str, default="./yolox_outputs")
    parser.add_argument("-D", dest="opts", action="append", default=[],
                        metavar="KEY=VALUE")
    add_device_flag(parser)
    return parser


def main(argv=None) -> int:
    import numpy as np

    args = make_parser().parse_args(argv)
    config = resolve_config(args.config)
    config.update(parse_model_config_opts(args.opts))
    setup_logger()

    from yolox_tpu_torch.models.yolox import YoloxModule

    module = YoloxModule.from_config(config, device=args.device)
    if args.ckpt:
        from yolox_tpu_torch.utils.checkpoint import load_checkpoint

        module.load_params(load_checkpoint(args.ckpt)["model"])

    loader = config.get_data_loader(
        batch_size=args.batch_size, is_distributed=False, no_aug=False)
    os.makedirs(args.output_dir, exist_ok=True)

    it = iter(loader)
    for b in range(args.max_batch):
        inps, targets, _, _ = next(it)
        prefix = os.path.join(args.output_dir, f"assign_vis_{b}_")
        module.visualize(np.asarray(inps), np.asarray(targets),
                         save_prefix=prefix)
        logger.info(f"batch {b}: wrote {inps.shape[0]} images to "
                    f"{prefix}*.png")
    loader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
