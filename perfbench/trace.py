"""The profiler's record of a traced window, reduced for the per-layer
readers (`perfbench/metrics/`).

The harness wraps the window in the annotation `perfbench.window` and each
call into the program in `perfbench.<step>` (its own spans, around the
program's entry points). Device intervals are the kernels, copies and
memsets that CUPTI recorded on the CUDA device (Chrome-trace categories
`kernel`, `gpu_memcpy`, `gpu_memset`), clipped to the window;
their union is the time the device was busy. An idle gap is named by what
the host was doing when it began: the innermost harness span and the
innermost operator open at that instant.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

WINDOW = "perfbench.window"
TOP = 10
NAME_CHARS = 120  # kernel names are C++ templates; the head names them


def _union(intervals):
    """Merged, sorted (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation")


def chrome_events(prof) -> list:
    """The profiler's events as its Chrome trace writes them (the one
    format every PyTorch release keeps), read back and the file removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


class TraceView:
    """Device intervals (name, category, start_ns, end_ns) and host spans
    of one traced window (Chrome-trace events: "cat", "name", "ts" and
    "dur" in microseconds), with the traffic's own record of it
    (`info`)."""

    def __init__(self, events, info: dict, cell: dict):
        self.info, self.cell = info, cell
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        window = [e for e in spans if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise RuntimeError("the trace has no perfbench.window span")
        self.t0 = int(float(window[0]["ts"]) * 1e3)
        self.t1 = self.t0 + int(float(window[0]["dur"]) * 1e3)
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device, self.host = [], []
        for e in spans:
            start = int(float(e["ts"]) * 1e3)
            end = start + int(float(e["dur"]) * 1e3)
            if end < self.t0 or start > self.t1:
                continue
            cat, name = e.get("cat"), e.get("name", "?")
            if cat in DEVICE:
                self.device.append((name, cat, max(start, self.t0),
                                    min(end, self.t1)))
            elif cat in HOST and name != WINDOW:
                self.host.append((name, cat, start, end))
        self.busy = _union([(s, t) for _, _, s, t in self.device])

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) / 1e9

    def idle_pct(self):
        """The share of the window in which no device interval runs, or
        None where the trace holds no device interval."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_time(self, pattern: str):
        """(seconds, count) of the device intervals whose name matches."""
        rx = re.compile(pattern)
        hits = [t - s for name, _, s, t in self.device if rx.search(name)]
        return sum(hits) / 1e9, len(hits)

    def idle_gaps(self):
        """[(start_ns, end_ns)] where no device interval runs."""
        gaps, at = [], self.t0
        for s, t in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if at < self.t1:
            gaps.append((at, self.t1))
        return gaps

    def host_activity(self, t_ns) -> str:
        """'<harness span> > <innermost operator>' open at t_ns."""
        span, op = "outside the program", None
        best_span = best_op = None
        for name, kind, s, e in self._host_open(t_ns):
            if kind == "user_annotation" and name.startswith("perfbench."):
                if best_span is None or s > best_span:
                    best_span, span = s, name
            elif best_op is None or s > best_op:
                best_op, op = s, name
        return f"{span} > {op}" if op else span

    def _host_open(self, t_ns):
        if not hasattr(self, "_starts"):
            self.host.sort(key=lambda h: h[2])
            self._starts = [h[2] for h in self.host]
        i = bisect.bisect_right(self._starts, t_ns)
        return [h for h in self.host[max(0, i - 4000):i] if h[3] >= t_ns]

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for name, _, s, t in self.device:
            ops[name[:NAME_CHARS]] += (t - s) / 1e9
        idle = collections.Counter()
        for s, t in self.idle_gaps():
            idle[self.host_activity(s)] += (t - s) / 1e9
        return {"device_ops": [[n, v] for n, v in ops.most_common(TOP)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(TOP)]}
