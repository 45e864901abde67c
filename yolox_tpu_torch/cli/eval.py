"""`yolox-tpu-torch eval`, the port's counterpart of `yolox_tpu/cli/eval.py`.

Same flags (--conf/--nms/--tsize/--fuse/--fp16/--int8/--int8-hbm/--legacy/
--test/--speed), plus --device; loads a checkpoint (default
`out/<name>/best_ckpt.pth`), runs the COCO evaluator on the module's
device (K1 and K2 each launch once a batch; with --int8 / --int8-hbm the
convs run on Q1 / Q2), prints AP50:95/AP50 and the per-class tables.
`-d`, `--num_machines`, `--machine_rank` and `--dist-url` evaluate in
several processes as `train` trains: each rank infers on its share of
the batches (`-b` is the global batch) and rank 0 computes the AP from
the gathered detections.
"""

from __future__ import annotations

import argparse
import os
import sys

from yolox_tpu_torch.cli.utils import (
    add_device_flag,
    launch,
    parse_model_config_opts,
    resolve_config,
)
from yolox_tpu_torch.config import validate_config
from yolox_tpu_torch.utils.logger import logger, setup_logger


def make_parser():
    parser = argparse.ArgumentParser("yolox-tpu-torch eval")
    parser.add_argument("-n", "--name", type=str, default=None)
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    parser.add_argument("-d", "--devices", type=int, default=None)
    parser.add_argument("--num_machines", type=int, default=1)
    parser.add_argument("--machine_rank", type=int, default=0)
    parser.add_argument("--dist-url", type=str, default=None)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint file (default "
                             "out/<name>/best_ckpt.pth)")
    parser.add_argument("--conf", type=float, default=None)
    parser.add_argument("--nms", type=float, default=None)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--fuse", action="store_true",
                        help="fuse conv+bn before eval")
    parser.add_argument("--fp16", action="store_true",
                        help="bf16 inference")
    parser.add_argument("--int8", action="store_true",
                        help="post-training int8 quantized inference "
                             "(calibrates activation scales on the first "
                             "--calib-batches eval batches, then runs "
                             "every conv+BN+act block on the int8 conv "
                             "kernels; see yolox_tpu_torch/ops/quant.py)")
    parser.add_argument("--int8-hbm", action="store_true",
                        help="int8-activations-in-HBM PTQ inference (codes "
                             "cross blocks; same calibration flags as "
                             "--int8)")
    parser.add_argument("--calib-batches", type=int, default=8,
                        help="number of eval batches used for int8 "
                             "activation-scale calibration")
    parser.add_argument("--calib-pct", type=float, default=None,
                        help="calibrate activation scales at this "
                             "percentile of |x| instead of the abs-max "
                             "(outlier clipping, e.g. 99.99)")
    parser.add_argument("--legacy", action="store_true",
                        help="legacy (ImageNet-normalized) preprocessing")
    parser.add_argument("--test", action="store_true",
                        help="evaluate on test-dev")
    parser.add_argument("--speed", action="store_true",
                        help="speed-test only (random weights)")
    parser.add_argument("-D", dest="opts", action="append", default=[],
                        metavar="KEY=VALUE")
    parser.add_argument("--seed", type=int, default=None)
    add_device_flag(parser)
    return parser


def run_eval(config, args):
    """Build the module and the evaluator, evaluate; returns (AP50:95,
    AP50, summary)."""
    import itertools as it

    import torch

    from yolox_tpu_torch.models.yolox import YoloxModule
    from yolox_tpu_torch.parallel.mesh import process_count
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint
    from yolox_tpu_torch.utils.model_utils import fuse_model, get_model_info

    is_distributed = process_count() > 1
    evaluator = config.get_evaluator(
        batch_size=args.batch_size, is_distributed=is_distributed,
        testdev=args.test, legacy=args.legacy)

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    module = YoloxModule.from_config(config, dtype=dtype, device=args.device)
    logger.info("Model Summary: "
                + get_model_info(module, config.test_size))

    if not args.speed:
        ckpt_file = args.ckpt or os.path.join(
            config.output_dir, args.name or config.name, "best_ckpt.pth")
        logger.info(f"loading checkpoint from {ckpt_file}")
        module.load_params(load_checkpoint(ckpt_file)["model"])
        logger.info("loaded checkpoint done.")

    if args.fuse:
        logger.info("\tFusing model...")
        fuse_model(module)

    if args.int8 or args.int8_hbm:
        logger.info(f"\tCalibrating int8 activation scales on "
                    f"{args.calib_batches} batches...")
        batches = (imgs for imgs, *_ in
                   it.islice(iter(evaluator.dataloader), args.calib_batches))
        qtab = module.calibrate_int8(batches, percentile=args.calib_pct)
        module.enable_int8(qtab, hbm=args.int8_hbm)
        logger.info(f"\tint8 enabled ({len(qtab)} calibrated conv blocks, "
                    f"mode={'hbm' if args.int8_hbm else 'ladder'}).")

    ap50_95, ap50, summary = config.eval(
        module, evaluator, is_distributed, half=args.fp16)
    logger.info("\n" + str(summary))
    return ap50_95, ap50, summary


def main(argv=None) -> int:
    launch(run, make_parser().parse_args(argv))
    return 0


def run(args):
    """The command in one process (a rank, under `launch`)."""
    from yolox_tpu_torch.parallel.mesh import process_index

    config = resolve_config(args.config)
    config.update(parse_model_config_opts(args.opts))
    if args.conf is not None:
        config.test_conf = args.conf
    if args.nms is not None:
        config.nmsthre = args.nms
    if args.tsize is not None:
        config.test_size = (args.tsize, args.tsize)
    if args.seed is not None:
        config.seed = args.seed
    validate_config(config)
    if args.name is None:
        args.name = config.name

    setup_logger(os.path.join(config.output_dir, args.name),
                 rank=process_index(), filename="eval_log.txt",
                 capture_std=True)
    try:
        return run_eval(config, args)
    finally:
        from yolox_tpu_torch.utils.logger import restore_sys_output

        restore_sys_output()


if __name__ == "__main__":
    sys.exit(main())
