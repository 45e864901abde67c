#!/usr/bin/env python
"""Serving-path breakdown of the port on the card: where do the ms go?
The counterpart of `scripts/profile_serve.py`.

Three cumulative stages of `YoloxModule.serve` on one input (float32
0-255 NHWC pixels from `np.random.default_rng(0)`, the module in
bfloat16 or, with `--dtype float32`, float32 with TF32 off):

  backbone                   the PAFPN (K1 runs the stem);
  backbone+head raw          + `head.forward_raw`;
  full serve (+decode+NMS)   `serve` (top-k, decode, K2) at max_det.

Each stage computes the JAX tool's checksum (NCHW here: JAX's
`f[:, 0, 0, :4]` of an NHWC map is `f[:, :4, 0, 0]`). JAX chains `iters`
calls in one jitted loop, which hides dispatch; eager PyTorch has no such
loop, so each stage gets two times:

  events ms   CUDA events around `iters` calls, best of 3: what an eager
              caller waits, host launches included;
  device ms   one call at a time queued behind a spin kernel that outlasts
              its launches, so the host's gaps do not show (mean of
              `iters`). A call of more than ~1 000 launches fills CUDA's
              launch queue before the spin ends, and a call that waits on
              the device inside stops the queue: then its gaps show.

busy = device / events. Beside them, kernels ms: the sum of the call's
kernel, copy and set durations from torch.profiler (2 calls), which no
gap enters; where it falls well below the device ms, the call's host
side holds the device back even when queued. FLOPs are the conv census of the stage
(`torch_serve_traffic_model.py`). Bytes count every aten op's inputs and
outputs once, under a `TorchDispatchMode` (the eager counterpart of XLA's
"bytes accessed"; views and allocations move nothing, a gather counts its
whole source), plus the arguments and results of K1 and K2, which eager
serving calls outside aten. The flop-bound and byte-bound ms are those
counts at the H100's peaks; MFU % and HBM % divide them by the device ms.

`--trace DIR` writes a Chrome trace of `iters` full-serve calls
(`DIR/serve_trace.json`, torch.profiler), in a run of its own after an
unprofiled call; `scripts/torch_trace_report.py DIR --iters N` reads it.

Runs on the CUDA card unless given `--device cpu`, and exits non-zero
when asked for a card that is not there. On the CPU it prints the
checksums and counts and no time ("not measured").

    python scripts/torch_profile_serve.py [--model nano] [--batch 256]
        [--iters 8] [--max-det 256] [--dtype {bfloat16,float32}]
        [--trace DIR] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from contextlib import contextmanager

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_serve_traffic_model import (  # noqa: E402
    DTYPES,
    SERVE_BATCH,
    conv_census,
    named_config,
)

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, float32 on
# the CUDA cores (TF32 off), HBM3 bandwidth
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12


# ------------------------------------------------- shared by the profilers

def card(device=None):
    """The device to profile: `device`, else the CUDA card. Exits with a
    message when a card is asked for and none is there: never the CPU in
    its place."""
    import torch

    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool profiles the card; "
                         "pass --device cpu for the CPU")
    return dev


def nvidia_smi():
    """`name, power.limit` of the card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def events_ms(fn, iters, repeats=3):
    """Best of `repeats` of the mean ms of `iters` calls of fn() between
    two CUDA events, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


# spin-kernel cycles a ms (the H100's ~1.98 GHz SM clock, rounded up)
SPIN_CYCLES_PER_MS = 2_000_000


def device_ms(fn, iters, host_ms):
    """Mean device ms of fn() over `iters` calls, each queued behind a
    spin kernel that lasts `host_ms` + 5 ms (at least its launches' host
    time), so its kernels run back to back."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * (host_ms + 5.0)))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_ms(fn, reps=2):
    """Device ms of fn() per call from torch.profiler (CUPTI): the sum of
    its kernels', copies' and sets' durations, so no gap between them
    counts, after one unprofiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: an aten op repeats its kernels' time
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def times(fn, iters, on_card):
    """{"events_ms", "device_ms", "kernel_ms"} of fn() on the card; None
    each elsewhere, after one call."""
    if not on_card:
        fn()
        return dict.fromkeys(("events_ms", "device_ms", "kernel_ms"))
    ev = events_ms(fn, iters)
    return {"events_ms": ev, "device_ms": device_ms(fn, iters, ev),
            "kernel_ms": kernel_ms(fn)}


def checked_call(fn):
    """(fn()'s checksum as a float, each hand kernel's launches in that
    call, by wrapper name (`launch_counts`); 0 on the CPU, where the plain
    versions run)."""
    from yolox_tpu_torch.utils.trace import launch_counts

    before = launch_counts()
    value = float(fn())
    return value, {k: n - before[k] for k, n in launch_counts().items()}


def write_trace(fn, iters, path, on_card, with_stack=False):
    """A Chrome trace (torch.profiler) of `iters` calls of fn(), after one
    unprofiled call; `with_stack` records the Python frames too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    fn()
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities, with_stack=with_stack) as prof:
        for _ in range(iters):
            fn()
        if on_card:
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    return path


def tensor_bytes(t) -> int:
    """Bytes of the memory a tensor addresses (an expanded dimension,
    stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _leaves_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# K1 and K2: eager serving calls their wrappers directly, outside aten
KERNEL_SITES = (("yolox_tpu_torch.models.blocks", "stem_conv_bn_act"),
                ("yolox_tpu_torch.ops.nms", "nms_keep"))


@contextmanager
def count_bytes():
    """Count the bytes of what runs inside: every aten op's tensor inputs
    read once and outputs written once (views, allocations and `detach`
    move nothing; `copy_` reads its source and writes its destination,
    `fill_` / `zero_` only write), and each kernel wrapper bound at
    `KERNEL_SITES` (module, name) by its arguments and results, with no op
    inside it counted. Yields a dict whose "bytes" grows ("kernel_bytes":
    the wrappers' share)."""
    import importlib

    import torch
    from torch.utils._python_dispatch import (
        TorchDispatchMode,
        _disable_current_modes,
    )

    aten = torch.ops.aten
    free = {aten.empty.memory_format, aten.empty_strided.default,
            aten.empty_like.default, aten.detach.default,
            aten.lift_fresh.default, aten._local_scalar_dense.default}
    write_only = {"fill_", "zero_", "random_", "uniform_", "normal_"}
    acc = {"bytes": 0, "kernel_bytes": 0}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.is_view or func in free:
                return out
            name = func.overloadpacket.__name__
            if name in write_only:
                n = _leaves_bytes(out)
            elif name == "copy_":
                n = tensor_bytes(args[0]) + tensor_bytes(args[1])
            else:
                n = _leaves_bytes((args, kwargs)) + _leaves_bytes(out)
            acc["bytes"] += n
            return out

    def counted(kernel):
        def wrapper(*args, **kwargs):
            with _disable_current_modes():
                out = kernel(*args, **kwargs)
            n = _leaves_bytes((args, kwargs)) + _leaves_bytes(out)
            acc["bytes"] += n
            acc["kernel_bytes"] += n
            return out
        return wrapper

    saved = []
    for mod_name, attr in KERNEL_SITES:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, counted(getattr(mod, attr)))
    try:
        with Mode():
            yield acc
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def roofline(row, flops, nbytes, dtype, batch):
    """Fill a stage row's counts, bounds and shares."""
    peak = H100_F32_FLOPS if dtype == "float32" else H100_BF16_FLOPS
    flop_ms = 1e3 * flops / peak
    byte_ms = 1e3 * nbytes / H100_HBM_BYTES
    dev, ev = row["device_ms"], row["events_ms"]
    row.update({
        "img_per_s": batch / ev * 1e3 if ev else None,
        "busy": dev / ev if ev else None,
        "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
        "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
        "mfu_pct": 100 * flop_ms / dev if dev else None,
        "hbm_pct": 100 * byte_ms / dev if dev else None})
    return row


def fmt(v, spec, unit=""):
    return "not measured" if v is None else format(v, spec) + unit


def print_row(row):
    print(f"{row['stage']:28s} events {fmt(row['events_ms'], '9.3f', ' ms')}"
          f"  device {fmt(row['device_ms'], '9.3f', ' ms')}"
          f"  kernels {fmt(row['kernel_ms'], '9.3f', ' ms')}"
          f"  {fmt(row['img_per_s'], '9.1f', ' img/s')}"
          f"  busy {fmt(row['busy'], '.3f')}"
          f"  flop-bound {row['flop_bound_ms']:7.3f} ms"
          f"  byte-bound {row['byte_bound_ms']:7.3f} ms"
          f"  MFU {fmt(row['mfu_pct'], '5.1f', '%')}"
          f"  HBM {fmt(row['hbm_pct'], '5.1f', '%')}", flush=True)


# ------------------------------------------------------------ the stages

def serve_stages(module, x, max_det, nms_thre):
    """[(stage name, census parts, fn)]: each fn runs the stage once on x
    and returns JAX's checksum as a 0-d float32 device tensor."""
    import torch

    def backbone_only():
        with torch.inference_mode():
            fpn = module.backbone(x.to(module.dtype))
            return sum(f[:, :4, 0, 0].float().sum() for f in fpn)

    def head_raw():
        with torch.inference_mode():
            fpn = module.backbone(x.to(module.dtype))
            raw, _, _ = module.head.forward_raw(fpn)
            return raw[:, 0, :4].float().sum()

    def full_serve():
        dets, _ = module.serve(x, conf_thre=0.5, nms_thre=nms_thre,
                               class_agnostic=False, max_det=max_det)
        return dets[:, 0, 0].sum()

    return [("backbone", ("backbone",), backbone_only),
            ("backbone+head raw", ("backbone", "head"), head_raw),
            ("full serve (+decode+NMS)", ("backbone", "head"), full_serve)]


def serve_input(batch, size, device):
    """float32 0-255 NHWC pixels from `default_rng(0)` (JAX's input)."""
    import torch

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="nano")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--max-det", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from yolox_tpu_torch import YoloxModule

    dev = card(args.device)
    on_card = dev.type == "cuda"
    if args.dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = named_config(args.model)
    size = cfg.test_size[0]
    b = args.batch or SERVE_BATCH[args.model]
    module = YoloxModule.from_config(cfg, dtype=getattr(torch, args.dtype),
                                     device=dev)
    x = serve_input(b, size, dev)
    census = conv_census(args.model, b, args.dtype, size)

    result = {"model": args.model, "batch": b, "size": size,
              "dtype": args.dtype, "iters": args.iters,
              "device": str(dev), "card": nvidia_smi() if on_card else None,
              "stages": []}
    if on_card:
        print("card:", result["card"])
    for tag, parts, fn in serve_stages(module, x, args.max_det, cfg.nmsthre):
        checksum, launches = checked_call(fn)
        with count_bytes() as acc:
            fn()
        row = roofline({"stage": tag, "checksum": checksum,
                        **times(fn, args.iters, on_card),
                        "launches": launches,
                        "kernel_gbytes": acc["kernel_bytes"] / 1e9},
                       sum(census["parts"][p][1] for p in parts),
                       acc["bytes"], args.dtype, b)
        result["stages"].append(row)
        print_row(row)
    if args.trace:
        stages = serve_stages(module, x, args.max_det, cfg.nmsthre)
        result["trace"] = write_trace(
            stages[-1][2], args.iters,
            os.path.join(args.trace, "serve_trace.json"), on_card)
        print(f"trace written to {result['trace']}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
