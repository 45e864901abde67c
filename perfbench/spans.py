"""The program's own spans in a traced window, for the per-layer readers.

`yolox_tpu_torch` records spans named `yolox.*` (`yolox_tpu_torch/utils/
trace.py`) while a profiler records: `yolox.serve` around a whole serve
call, `yolox.h2d` around its host-to-device copy, and the model's stages
inside. They are `user_annotation` events of the same trace as the
device's kernels, on the same clock, so an idle gap of the device can be
put down to the span the host was in when it began. A program without
spans (an older checkout) leaves every list here empty.
"""

from __future__ import annotations

import bisect

SERVE = "yolox.serve"
H2D = "yolox.h2d"


def program_spans(view, name: str) -> list:
    """[(name, start_ns, end_ns)] of the program's spans `name` that
    overlap the window, in start order."""
    return sorted(((n, s, e) for n, cat, s, e in view.host
                   if cat == "user_annotation" and n == name),
                  key=lambda h: h[1])


def serve_calls(view) -> list:
    """[(start_ns, end_ns, h2d_ns)] of the `yolox.serve` spans lying
    wholly inside the window, each with the time of the `yolox.h2d` spans
    inside it."""
    h2d = program_spans(view, H2D)
    calls = []
    for _, s, e in program_spans(view, SERVE):
        if s < view.t0 or e > view.t1:
            continue
        copy = sum(he - hs for _, hs, he in h2d if hs >= s and he <= e)
        calls.append((s, e, copy))
    return calls


class OpenSpans:
    """Whether one of a list of non-overlapping spans is open at an
    instant."""

    def __init__(self, spans):
        self.spans = sorted((s, e) for _, s, e in spans)
        self.starts = [s for s, _ in self.spans]

    def at(self, t_ns) -> bool:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        return i >= 0 and t_ns < self.spans[i][1]
