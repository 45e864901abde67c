"""The port's own spans and its kernels' launch counters.

`span(name)` is `torch.profiler.record_function(name)` while a profiler
records, and a shared null context otherwise: a bare `record_function`
costs the host several microseconds a span even with no profiler, the
check ~1 µs. Under `torch.profiler` the spans land on the same clock as
the device's kernels and copies, so a trace can say which part of a call
the host was in when the device ran dry. `torch.export` traces with no
profiler recording, so an exported program holds no span.

The spans (`SPANS`), outer to inner:

    yolox.serve          YoloxModule.serve_body / serve_meshed, whole
    yolox.h2d            YoloxModule._image_batch: staging, copy, cast,
                         layout
    yolox.backbone       the backbone (and neck) of a serve call
    yolox.k1             the stem kernel K1 (ops/stem.py), in the backbone
    yolox.head           the head's raw level outputs
    yolox.postprocess    select, decode and NMS (ops/nms.py)
    yolox.k2             the NMS kernel K2 (ops/nms_kernel.py)
    yolox.dispatch       Yolox._dispatch: letterbox and serve call
    yolox.letterbox      YoloxProcessor.__call__
    yolox.fetch          Yolox._fetch: detections to the host
    yolox.train.*        make_train_step's forward, assign, losses,
                         backward (the gradient all-reduce too), sgd, ema

`launch_counts()` reads every hand kernel's launch counter (each wrapper's
`.launches` attribute) by wrapper name; `copy_counts()` the host-to-device
copy's routes (`utils/h2d.py`): batches staged through pinned memory and
their bytes, pinned sources copied directly, plain pageable copies.
"""

from __future__ import annotations

import contextlib

import torch

SERVE_SPANS = ("yolox.serve", "yolox.h2d", "yolox.backbone", "yolox.k1",
               "yolox.head", "yolox.postprocess", "yolox.k2")
CLIENT_SPANS = ("yolox.dispatch", "yolox.letterbox", "yolox.fetch")
TRAIN_SPANS = ("yolox.train.forward", "yolox.train.assign",
               "yolox.train.losses", "yolox.train.backward",
               "yolox.train.sgd", "yolox.train.ema")
SPANS = SERVE_SPANS + CLIENT_SPANS + TRAIN_SPANS

NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context for the span `name`: recorded while a profiler records
    (and nothing compiles), else the shared null context."""
    if _recording() and not torch.compiler.is_compiling():
        return torch.profiler.record_function(name)
    return NULL


def launch_counts() -> dict:
    """{wrapper name: launches so far} of the hand kernels K1-K5, Q1 and
    Q2; on CPU tensors the plain versions run and count nothing."""
    from yolox_tpu_torch.ops.conv_bwd import main_1x1, reduce_sums
    from yolox_tpu_torch.ops.int8_conv import int8_conv, int8_dwconv
    from yolox_tpu_torch.ops.nms_kernel import nms_keep
    from yolox_tpu_torch.ops.shear_kernel import shear_x, shear_xy
    from yolox_tpu_torch.ops.stem import stem_conv_bn_act

    return {f.__name__: f.launches for f in (
        stem_conv_bn_act, nms_keep, reduce_sums, main_1x1, shear_x,
        shear_xy, int8_conv, int8_dwconv)}


def copy_counts() -> dict:
    """{"staged", "staged_bytes", "pinned_direct", "pageable"}: the image
    batches copied to a CUDA device so far by each route of
    `utils/h2d.to_device` (and the bytes staged); a CPU module copies
    nothing and counts nothing."""
    from yolox_tpu_torch.utils import h2d

    return dict(h2d.COUNTS)
