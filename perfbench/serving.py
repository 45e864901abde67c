"""What the serving cells share: the seeded state, the program under test
built from it, and the check of the window's detections against the
float32 reference.

The program is `yolox_tpu_torch`, entered only through its public API:
the network that the configuration's architecture builds
(`perfbench/archs/<arch>.py::program`), `YoloxModule.serve` and `Yolox`.
The reference network, too, is the architecture's.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from perfbench import cells, compare, images
from perfbench.reference import precision
from perfbench.weights import (CALIBRATION_SHAPES, calibrate, seeded_state,
                               state_shapes)

# the reference's batch when it recomputes the compared images
REF_BLOCK = 8


def make_state(config: dict, seed: int, device, dtype=None) -> dict:
    """The configuration's seeded, calibrated state in its serving dtype
    (or `dtype`), made on `device` (`perfbench/weights.py`)."""
    dtype = dtype or getattr(torch, config["dtype"])
    arch = cells.arch(config)
    with precision.strict_float32():
        ref = arch.reference(config, device=device)
        state = seeded_state(state_shapes(ref), config["init"], seed, device,
                             dtype, arch)
        size = config["input_size"]
        scale = size[0] / 640
        shapes = [(int(h * scale), int(w * scale))
                  for h, w in CALIBRATION_SHAPES]
        frames = images.frames(shapes, seed + 2, device)
        cal = torch.from_numpy(np.stack([images.letterboxed(f, size)
                                         for f in frames])).to(device)
        state = calibrate(ref, state, cal, seed, dtype)
    del ref, cal
    return state


def build_module(config: dict, state: dict, device, dtype=None):
    """The program's network at the configuration's sizes with `state`
    loaded, in eval mode, in the configuration's dtype (or `dtype`), and
    the program's config object."""
    return cells.arch(config).program(
        config, state, device, dtype or getattr(torch, config["dtype"]))


def free_program() -> None:
    """Return the memory of the program's dropped state to the device
    before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_judge(cell: dict, state_host: dict, pool_images, programs,
                    device) -> dict:
    """Judge the program's detections of each pool image against the
    float32 reference. pool_images: NHWC uint8 canvases at the input size;
    programs[i]: the (n, 6) rows (`rows_from_serve`) of every compared
    output of image i. Returns {"check", "correct", "counts"}."""
    serve, margins = cell["traffic"]["serve"], cell["margins"]
    tally = compare.Tally()
    with precision.strict_float32(), torch.no_grad():
        ref = cells.arch(cell["config"]).reference(cell["config"],
                                                  device=device)
        ref.load_state_dict({k: v.float() for k, v in state_host.items()})
        for i in range(0, len(pool_images), REF_BLOCK):
            x = torch.from_numpy(np.stack(pool_images[i:i + REF_BLOCK]))
            for j, dec in enumerate(ref.decoded(x.to(device)), i):
                cand = compare.candidate_rows(dec, serve["conf_thre"],
                                              margins["score"])
                for rows in programs[j]:
                    tally.add(rows, dec, cand, serve["conf_thre"],
                              serve["nms_thre"], serve["max_det"],
                              margins["score"], margins["iou"])
    del ref
    check, ok = compare.judge(tally.numbers(), tally.images, cell["limits"])
    return {"check": check, "correct": ok, "counts": tally.counts()}


def rows_from_serve(dets: np.ndarray, valid: np.ndarray) -> list:
    """`serve`'s (B, max_det, 7) rows (x1, y1, x2, y2, obj, cls_conf, cls)
    and (B, max_det) mask -> per image (n, 6) rows (box, score, class)."""
    out = []
    for d, v in zip(dets, valid):
        d = d[v].astype(np.float64)
        out.append(np.concatenate([d[:, :4], d[:, 4:5] * d[:, 5:6],
                                   d[:, 6:7]], 1))
    return out


def control_rows(cell: dict, state_host: dict, pool_images, device) -> list:
    """The control in the program's place: the reference computed with
    every conv's input and weight rounded to float8 e4m3
    (`reference/precision.py`), through the reference's own postprocess,
    as (n, 6) rows per image, in input pixels."""
    from perfbench.reference.postprocess import detect

    serve = cell["traffic"]["serve"]
    out = []
    with precision.strict_float32(), torch.no_grad():
        ref = cells.arch(cell["config"]).reference(
            cell["config"], quant=precision.fp8, device=device)
        ref.load_state_dict({k: v.float() for k, v in state_host.items()})
        for i in range(0, len(pool_images), REF_BLOCK):
            x = torch.from_numpy(np.stack(pool_images[i:i + REF_BLOCK]))
            for d in detect(ref.decoded(x.to(device)), serve["conf_thre"],
                            serve["nms_thre"], serve["max_det"]):
                out.append(np.concatenate([d[:, :4], d[:, 4:5] * d[:, 5:6],
                                           d[:, 6:7]], 1))
    del ref
    return out
