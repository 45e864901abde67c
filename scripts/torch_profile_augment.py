#!/usr/bin/env python
"""Device-augmentation breakdown of the port on the card: where do the ms
go? The counterpart of `scripts/profile_augment.py`.

Times `data/device_augment.py::device_augment_batch` (Mosaic, the
decomposed affine warp whose shear passes run K5, MixUp, HSV, flips,
label packing) on JAX's synthetic batch (seed 0: uint8 tiles, their
sizes, 8 boxes a tile), the generator re-seeded with i for call i (the
counterpart of `fold_in(key, i)`). Prints the engine's ms a batch (events
ms, best of 3 runs of `iters` calls; device ms, each call queued behind a
spin kernel; kernels ms, their own time from torch.profiler; see
`scripts/torch_profile_serve.py`) and img/s.

Then it traces `iters` calls (torch.profiler, `with_stack=True`, written
to `--trace DIR/augment_trace.json`) and prints per-op device totals and
counts an iteration, each attributed to the innermost frame under
`yolox_tpu_torch/` that launched it, the counterpart of JAX's HLO source
metadata: a kernel's CUDA launch is found by the trace's correlation id
and placed in the Python frames recorded around it. A frame is printed as
the tracer names it, `file(first line of the function): function`; the
launch plumbing (`ops/_build.py`) is skipped, so a hand kernel stands at
its wrapper. On the CPU there is no device: the table holds the top-level
CPU ops and their host ms instead.

Runs on the CUDA card unless given `--device cpu`, and exits non-zero
when asked for a card that is not there.

    python scripts/torch_profile_augment.py [--batch 64] [--iters 8]
        [--size 640] [--trace $TMPDIR/aug_trace] [--top 25]
        [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_profile_serve import (  # noqa: E402
    card,
    checked_call,
    fmt,
    nvidia_smi,
    times,
    write_trace,
)
from torch_trace_report import DEVICE_CATEGORIES  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, float32 on
# the CUDA cores (TF32 off), HBM3 bandwidth
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12

PACKAGE = "yolox_tpu_torch/"
PLUMBING = ("yolox_tpu_torch/ops/_build.py",)
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def augment_inputs(batch, size):
    """JAX's synthetic batch: (tiles (B, 5, S, S, 3) uint8, hw (B, 5, 2),
    labels (B, 5, 60, 5) with 8 boxes a tile)."""
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 255, (batch, 5, size, size, 3), dtype=np.uint8)
    hw = np.full((batch, 5, 2), float(size), np.float32)
    lab = np.zeros((batch, 5, 60, 5), np.float32)
    lab[:, :, :8, :4] = rng.uniform(10, size - 10, (batch, 5, 8, 4))
    lab[:, :, :8, 2:4] += 32
    return tiles, hw, lab


def engine(tiles, hw, labels, size, iters, generator):
    """fn() running `device_augment_batch` once, re-seeding the generator
    with i = 0 .. iters - 1 in turn; returns JAX's checksum."""
    from yolox_tpu_torch.data.device_augment import device_augment_batch

    calls = [0]

    def one():
        generator.manual_seed(calls[0] % iters)
        calls[0] += 1
        imgs, packed = device_augment_batch(tiles, hw, labels, generator,
                                            out_size=(size, size))
        return (imgs[:, 0, 0, 0].float().sum()
                + packed[:, 0, 1].float().sum())

    return one


def _frames(events):
    """{(pid, tid): (starts, [(start, end, name)])} of the Python frames
    under the package (launch plumbing left out), by start."""
    frames = collections.defaultdict(list)
    for e in events:
        name = str(e.get("name", ""))
        if (e.get("cat") == "python_function" and e.get("ph") == "X"
                and PACKAGE in name
                and not any(p in name for p in PLUMBING)):
            ts = float(e["ts"])
            frames[(e.get("pid"), e.get("tid"))].append(
                (ts, ts + float(e.get("dur", 0.0)), name))
    out = {}
    for key, fs in frames.items():
        fs.sort()
        out[key] = ([f[0] for f in fs], fs)
    return out


def innermost(frames, pid, tid, t):
    """The innermost package frame open at host time t, or None."""
    starts, fs = frames.get((pid, tid), ((), ()))
    best = None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, e, name = fs[i]
        if e >= t:
            best = name  # the latest-starting open frame is the innermost
            break
    return best


def attribute(events, iters):
    """Per (op, frame) totals an iteration, largest first: [{"name",
    "frame", "ms", "count", "device"}]. Device events (kernels, copies,
    sets) are placed by their launch (correlation id); with none, the
    top-level CPU ops by their own start (host ms, "device" False)."""
    frames = _frames(events)
    device = [e for e in events if e.get("ph") == "X" and "dur" in e
              and e.get("cat") in DEVICE_CATEGORIES]
    totals = collections.defaultdict(float)
    counts = collections.Counter()
    if device:
        launches = {}
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
                launches[corr] = e
        for e in device:
            host = launches.get(e.get("args", {}).get("correlation"))
            frame = None if host is None else innermost(
                frames, host.get("pid"), host.get("tid"), float(host["ts"]))
            key = (e.get("name", "?"), frame or "?")
            totals[key] += float(e["dur"])
            counts[key] += 1
    else:
        ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                      and e.get("ph") == "X"),
                     key=lambda e: (e.get("tid"), float(e["ts"])))
        end = {}
        for e in ops:  # a top-level op starts after the last one ended
            ts, tid = float(e["ts"]), e.get("tid")
            if ts < end.get(tid, -1.0):
                continue
            end[tid] = ts + float(e["dur"])
            key = (e.get("name", "?"), innermost(
                frames, e.get("pid"), tid, ts) or "?")
            totals[key] += float(e["dur"])
            counts[key] += 1
    rows = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))
    return [{"name": name, "frame": frame, "ms": us / 1e3 / iters,
             "count": counts[(name, frame)] / iters, "device": bool(device)}
            for (name, frame), us in rows]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--trace", default=os.path.join(tempfile.gettempdir(),
                                                    "aug_trace"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    dev = card(args.device)
    on_card = dev.type == "cuda"
    b, size, iters = args.batch, args.size, args.iters
    tiles, hw, labels = (torch.from_numpy(a).to(dev)
                         for a in augment_inputs(b, size))
    one = engine(tiles, hw, labels, size, iters,
                 torch.Generator(device=dev))
    result = {"batch": b, "size": size, "iters": iters, "device": str(dev),
              "card": nvidia_smi() if on_card else None}
    if on_card:
        print("card:", result["card"])
    result["checksum"], result["launches"] = checked_call(one)
    result.update(times(one, iters, on_card))
    ev, devt = result["events_ms"], result["device_ms"]
    result.update({"img_per_s": b / ev * 1e3 if ev else None,
                   "busy": devt / ev if ev else None})
    print(f"full engine: events {fmt(ev, '8.3f', ' ms')}/batch, device "
          f"{fmt(devt, '8.3f', ' ms')}/batch, kernels "
          f"{fmt(result['kernel_ms'], '8.3f', ' ms')}/batch "
          f"({fmt(result['img_per_s'], '9.1f')} img/s of augmentation)",
          flush=True)

    path = write_trace(one, iters, os.path.join(args.trace,
                                                "augment_trace.json"),
                       on_card, with_stack=True)
    with open(path) as f:
        ops = attribute(json.load(f)["traceEvents"], iters)
    result["trace"] = path
    result["ops"] = ops[:args.top]
    what = "device" if on_card else "host (CPU ops; no device)"
    print(f"\nper-op {what} totals an iteration over {iters} iters "
          f"(sum {sum(o['ms'] for o in ops):.3f} ms/iter):")
    for op in ops[:args.top]:
        print(f"  {op['ms']:8.3f} ms  x{op['count']:<6g} {op['frame']:<60s}"
              f"  {op['name'][:120]}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
