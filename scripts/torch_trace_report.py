#!/usr/bin/env python
"""Aggregate torch.profiler Chrome traces into a per-op device-time
table: the counterpart of `scripts/trace_report.py`. Needs no device
(JSON parsing only).

    python scripts/torch_trace_report.py <trace file or dir> [--top 25]
        [--iters N]

Reads one trace file (`.json` or `.json.gz`), or every `*.json`,
`*.json.gz` and `*.pt.trace.json` in a directory: the traces that
`scripts/torch_profile_serve.py --trace`, `torch_profile_train.py
--trace` and the Trainer (`trace_rank{r}.json` under
`$YOLOX_PROFILE_DIR`) write. Device events are those of category
`kernel`, `gpu_memcpy` or `gpu_memset`; CPU ops, Python frames and CUDA
runtime calls are not counted. Prints the device tracks found (process /
thread names), the total device op time, and per op name the total ms
and its share, descending, with `--iters` also us an iteration (the name
last, cut at 120 characters); then the same as one JSON line, names
whole.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# printed characters of an op's name (CUDA's demangled names run to
# hundreds); the JSON line keeps them whole
NAME_WIDTH = 120


def trace_paths(path: str):
    if os.path.isfile(path):
        return [path]
    paths = set()
    for pattern in ("*.json", "*.json.gz", "*.pt.trace.json"):
        paths.update(glob.glob(os.path.join(path, pattern)))
    if not paths:
        raise SystemExit(f"no trace (*.json, *.json.gz) at {path}")
    return sorted(paths)


def load_events(path: str):
    """Every trace event of the file or directory `path`."""
    events = []
    for p in trace_paths(path):
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            data = json.load(f)
        events.extend(data.get("traceEvents", [])
                      if isinstance(data, dict) else data)
    return events


def device_events(events):
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATEGORIES]


def device_tracks(events, device):
    """'process / thread' names of the tracks holding device events."""
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                     "thread_name"):
            key = (e.get("pid"), e.get("tid") if e["name"] == "thread_name"
                   else None)
            names[key] = str(e.get("args", {}).get("name", ""))
    tracks = sorted({(e.get("pid"), e.get("tid")) for e in device},
                    key=str)
    return [f"{names.get((pid, None), pid)} / {names.get((pid, tid), tid)}"
            for pid, tid in tracks]


def report(events, top=25, iters=None) -> dict:
    """{"tracks", "total_ms", "us_per_iter", "ops": [{"name", "ms",
    "share", "count", "us_per_iter"}, ...] largest first, top N}."""
    device = device_events(events)
    per_op = collections.defaultdict(float)
    counts = collections.Counter()
    for e in device:
        per_op[e.get("name", "?")] += float(e["dur"])
        counts[e.get("name", "?")] += 1
    total = sum(per_op.values())
    ops = sorted(per_op.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
    return {
        "tracks": device_tracks(events, device),
        "total_ms": total / 1e3,
        "us_per_iter": total / iters if iters else None,
        "ops": [{"name": name, "ms": dur / 1e3,
                 "share": dur / total, "count": counts[name],
                 "us_per_iter": dur / iters if iters else None}
                for name, dur in ops]}


def print_report(rep):
    if not rep["tracks"]:
        print("no device track found (no kernel, gpu_memcpy or gpu_memset "
              "event): a trace taken without CUDA activity")
    else:
        print(f"device tracks: {rep['tracks']}")
    per_iter = rep["us_per_iter"]
    print(f"total device op time: {rep['total_ms']:.3f} ms"
          + (f"  ({per_iter:.1f} us/iter)" if per_iter is not None else ""))
    for op in rep["ops"]:
        line = f"{op['ms']:9.3f} ms  {100 * op['share']:5.1f}%"
        if op["us_per_iter"] is not None:
            line += f"  {op['us_per_iter']:8.1f} us/iter"
        print(f"{line}  {op['name'][:NAME_WIDTH]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--iters", type=int, default=None)
    args = ap.parse_args(argv)

    rep = report(load_events(args.trace_dir), args.top, args.iters)
    print_report(rep)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
