"""`yolox-tpu-torch demo`, the port's counterpart of `yolox_tpu/cli/demo.py`:
image / folder / video inference with drawn boxes, on the card unless
`--device cpu`.

Images and frames go through `Yolox.stream` (`--batch` a batch; the next
batch's decode and letterbox overlap the device's work on this one), so
K1 and K2 launch once a batch, and with `--int8` the convs run on Q1.
Drawing (`--save_result`) and video need cv2.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from yolox_tpu_torch.cli.utils import (
    add_device_flag,
    parse_model_config_opts,
    resolve_config,
)
from yolox_tpu_torch.utils.logger import logger, setup_logger

IMAGE_EXT = (".jpg", ".jpeg", ".webp", ".bmp", ".png")


def make_parser():
    parser = argparse.ArgumentParser("yolox-tpu-torch demo")
    parser.add_argument("demo_type", default="image", nargs="?",
                        choices=["image", "video"],
                        help="demo type")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--path", type=str, required=True,
                        help="image file / directory / video file")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint (default: pretrained weights)")
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--nms", type=float, default=None)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--save_result", action="store_true")
    parser.add_argument("--batch", type=int, default=1,
                        help="images per device batch for the pipelined "
                             "stream (throughput knob; latency prefers 1)")
    parser.add_argument("--output-dir", type=str, default="./yolox_outputs")
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="int8 PTQ inference, calibrated on the first "
                             "input image/frame (yolox_tpu_torch/ops/"
                             "quant.py)")
    parser.add_argument("-D", dest="opts", action="append", default=[],
                        metavar="KEY=VALUE")
    add_device_flag(parser)
    return parser


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"yolox-tpu-torch demo: {what} needs cv2 (opencv-python), "
            "which this host does not have") from e
    return cv2


def _image_files(path: Path):
    return ([path] if path.is_file() else sorted(
        p for p in path.rglob("*") if p.suffix.lower() in IMAGE_EXT))


def _load_model(config, args):
    import torch

    from yolox_tpu_torch.models.processor import YoloxProcessor
    from yolox_tpu_torch.models.yolox import Yolox, YoloxModule

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    if args.ckpt:
        from yolox_tpu_torch.utils.checkpoint import load_checkpoint

        module = YoloxModule.from_config(config, dtype=dtype,
                                         device=args.device)
        module.load_params(load_checkpoint(args.ckpt)["model"])
    else:
        module = YoloxModule.from_pretrained(config.name, dtype=dtype,
                                             device=args.device)
    return Yolox(module, YoloxProcessor(config))


def _calibrate_int8(model, args):
    """Calibrate the int8 activation table on the first input and switch
    the wrapper's serving path to the quantized graph (the ladder)."""
    import numpy as np
    from PIL import Image

    path = Path(args.path)
    if args.demo_type == "image":
        files = _image_files(path)
        if not files:
            raise RuntimeError(
                f"--int8: no image under {args.path} to calibrate on")
        images = [Image.open(files[0])]
    else:
        cap = _cv2("video").VideoCapture(args.path)
        ret, frame = cap.read()
        cap.release()
        if not ret:
            # serving the float graph after --int8 was asked for would
            # report every number as quantized
            raise RuntimeError(
                f"--int8: could not read a calibration frame from "
                f"{args.path}")
        images = [np.ascontiguousarray(frame[:, :, ::-1])]
    model.int8_qtab = model.module.calibrate_int8(model.processor(images))
    logger.info(f"int8 calibration on {args.path}: "
                f"{len(model.int8_qtab)} conv blocks")


def _draw(image_bgr, dets, conf, class_names):
    import numpy as np

    from yolox_tpu_torch.utils.visualize import vis

    boxes = np.asarray(dets["bboxes"], np.float32).reshape(-1, 4)
    scores = np.asarray(dets["scores"], np.float32)
    labels = np.asarray(dets["labels"], np.int64)
    return vis(image_bgr, boxes, scores, labels, conf=conf,
               class_names=class_names)


def demo_images(model, args, class_names):
    """Detections of every image under `args.path`, in file order; with
    `--save_result` each is drawn into `--output-dir`."""
    from PIL import Image

    files = _image_files(Path(args.path))
    out_dir = Path(args.output_dir)
    cv2 = None
    if args.save_result:
        cv2 = _cv2("--save_result")
        out_dir.mkdir(parents=True, exist_ok=True)

    # a batch's device time surfaces at its first yield and save work
    # bills to the next, so only the end-to-end mean is reported
    t0 = time.time()
    results = []
    for f, dets in zip(files, model.stream(
            (Image.open(f) for f in files), threshold=args.conf,
            batch_size=args.batch)):
        results.append(dets)
        logger.info(f"{f.name}: {len(dets['labels'])} objects")
        if cv2 is not None:
            img = _draw(cv2.imread(str(f)), dets, args.conf, class_names)
            out = out_dir / f.name
            cv2.imwrite(str(out), img)
            logger.info(f"saved {out}")
    if results:
        total = time.time() - t0
        logger.info(f"{len(results)} images in {total:.2f} s "
                    f"({total * 1000 / len(results):.1f} ms/image "
                    "end-to-end, incl. decode/draw/save)")
    return results


def demo_video(model, args, class_names):
    """Detections of every frame of the video `args.path`, in order; with
    `--save_result` the drawn frames are written to `--output-dir`."""
    from collections import deque

    cv2 = _cv2("video")
    cap = cv2.VideoCapture(args.path)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    writer = None
    if args.save_result:
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path = str(out_dir / Path(args.path).name)
        writer = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
            (width, height))
        logger.info(f"writing to {out_path}")
    # frames wait in a FIFO until their detections come back; the stream
    # runs at most one batch ahead (~2 * batch frames)
    in_flight = deque()

    def frames():
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            in_flight.append(frame)
            yield frame[:, :, ::-1]  # the model takes RGB

    results = []
    for dets in model.stream(frames(), threshold=args.conf,
                             batch_size=args.batch):
        frame = in_flight.popleft()
        results.append(dets)
        if writer is not None:
            writer.write(_draw(frame, dets, args.conf, class_names))
    cap.release()
    if writer is not None:
        writer.release()
    logger.info(f"processed {len(results)} frames")
    return results


def run(args):
    """The demo of parsed `args`; returns the detections, one dict per
    image or frame."""
    config = resolve_config(args.config)
    config.update(parse_model_config_opts(args.opts))
    if args.nms is not None:
        config.nmsthre = args.nms
    if args.tsize is not None:
        config.test_size = (args.tsize, args.tsize)

    from yolox_tpu_torch.data.datasets import COCO_CLASSES

    class_names = (COCO_CLASSES if config.num_classes == len(COCO_CLASSES)
                   else tuple(str(i) for i in range(config.num_classes)))
    model = _load_model(config, args)
    if args.int8:
        _calibrate_int8(model, args)
    if args.demo_type == "image":
        return demo_images(model, args, class_names)
    return demo_video(model, args, class_names)


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    setup_logger()
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
