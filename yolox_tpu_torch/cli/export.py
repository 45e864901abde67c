"""`yolox-tpu-torch export`, the port's counterpart of
`yolox_tpu/cli/export.py`: the serving computation as a `torch.export`
program (in place of the JAX package's StableHLO artifact) plus the
weights as an upstream-compatible `.pth`.

The program takes a (B, H, W, 3) float32 NHWC batch. By default it is the
forward with the in-graph decode ((B, A, 5 + C) rows), with `--no-decode`
the raw head outputs (decode them with `utils/demo_utils.demo_postprocess`),
with `--include-postprocess` the fused serving step of
`YoloxModule.make_serving_fn` (confidence filter, top-k, decode, NMS;
(B, max_det, 7) detections and a (B, max_det) valid mask). `--int8` bakes
an int8 ladder table, calibrated on `--calib-images`, and the quantized
weights into the program as constants.

The hand-written kernels are in the program as the operators of
`ops/library.py` (K1, K2, and Q1 / Q2 with `--int8`), so it runs them on
the card. Loading it needs them registered:

    import yolox_tpu_torch  # registers the yolox_tpu_torch:: operators
    program = torch.export.load("model.pt2").module()
    with torch.inference_mode():
        dets, valid = program(x)  # --include-postprocess
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
    parser = argparse.ArgumentParser("yolox-tpu-torch export")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint (default: pretrained weights)")
    parser.add_argument("--output", type=str, default="model.pt2")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--include-postprocess", action="store_true",
                        help="bake confidence filter + NMS into the "
                             "exported program")
    parser.add_argument("--conf", type=float, default=0.5)
    parser.add_argument("--max-det", type=int, default=256)
    parser.add_argument("--decode_in_inference", action="store_true",
                        default=True)
    parser.add_argument("--no-decode", dest="decode_in_inference",
                        action="store_false",
                        help="export raw head outputs (use "
                             "demo_postprocess to decode)")
    parser.add_argument("--int8", action="store_true",
                        help="export the int8-PTQ serving graph "
                             "(yolox_tpu_torch/ops/quant.py); the "
                             "calibration table is baked into the program "
                             "as constants — requires --calib-images")
    parser.add_argument("--calib-images", nargs="+", default=[],
                        help="image files/globs for int8 activation-"
                             "scale calibration")
    parser.add_argument("-D", dest="opts", action="append", default=[],
                        metavar="KEY=VALUE")
    add_device_flag(parser)
    return parser


def export_program(fn, x):
    """`torch.export.export(fn, (x,))` of a `ServingFn` (what
    `make_serving_fn` returns), in no-grad mode. `fn` is called once
    first, which makes an int8 table's quantized weights; constants made
    in inference mode are cloned, so the program also runs with autograd
    on. A meshed `ServingFn` (`make_serving_fn(mesh=...)`) raises
    RuntimeError: its exchanges between processes run eagerly only."""
    import torch

    fn(x)
    with torch.no_grad():
        program = torch.export.export(fn, (x,), strict=False)
    for name, value in list(program.constants.items()):
        if isinstance(value, torch.Tensor) and value.is_inference():
            program.constants[name] = value.clone()
    return program


def load_program(path):
    """`torch.export.load(path)`, after registering the port's operators;
    an unknown `yolox_tpu_torch::` operator is named in the error."""
    import torch

    import yolox_tpu_torch.ops.library  # noqa: F401

    try:
        return torch.export.load(path)
    except Exception as e:
        if "yolox_tpu_torch" in str(e):
            raise RuntimeError(
                f"{path}: the program calls yolox_tpu_torch:: operators; "
                "`import yolox_tpu_torch` before torch.export.load") from e
        raise


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    config = resolve_config(args.config)
    config.update(parse_model_config_opts(args.opts))
    if args.tsize is not None:
        config.test_size = (args.tsize, args.tsize)
    setup_logger()

    import torch

    from yolox_tpu_torch.models.weights import save_pth_state_dict
    from yolox_tpu_torch.models.yolox import ServingFn, YoloxModule

    if args.ckpt:
        from yolox_tpu_torch.utils.checkpoint import load_checkpoint

        module = YoloxModule.from_config(config, device=args.device)
        module.load_params(load_checkpoint(args.ckpt)["model"])
    else:
        module = YoloxModule.from_pretrained(config.name, device=args.device)
    module.head.decode_in_inference = args.decode_in_inference

    qtab = None
    if args.int8:
        import glob as globlib

        from PIL import Image

        from yolox_tpu_torch.models.processor import YoloxProcessor

        paths = [p for pat in args.calib_images
                 for p in sorted(globlib.glob(pat))]
        if not paths:
            logger.error("--int8 needs calibration data: pass "
                         "--calib-images FILES/GLOBS")
            return 1
        batch = YoloxProcessor(config)([Image.open(p) for p in paths])
        qtab = module.calibrate_int8(batch)
        logger.info(f"int8 calibration: {len(paths)} images, "
                    f"{len(qtab)} conv blocks")

    if args.include_postprocess:
        fn = module.make_serving_fn(
            conf_thre=args.conf, nms_thre=config.nmsthre,
            max_det=args.max_det, int8_qtab=qtab)
    else:
        fn = ServingFn(module.forward_body,
                       mode="ladder" if qtab is not None else None,
                       table=qtab)
    x = torch.zeros((args.batch_size, config.test_size[0],
                     config.test_size[1], 3), dtype=torch.float32,
                    device=module.device)
    program = export_program(fn, x)
    torch.export.save(program, args.output)
    weights_path = os.path.splitext(args.output)[0] + "_weights.pth"
    save_pth_state_dict(module.state_dict(), weights_path)
    logger.info(
        f"exported a torch.export program to {args.output} "
        f"({os.path.getsize(args.output) / 1e6:.1f} MB) and weights to "
        f"{weights_path}; input (B={args.batch_size}, "
        f"{config.test_size[0]}x{config.test_size[1]}x3 NHWC f32) on "
        f"{module.device}; load it after `import yolox_tpu_torch`")
    return 0


if __name__ == "__main__":
    sys.exit(main())
