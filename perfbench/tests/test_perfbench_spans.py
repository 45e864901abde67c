"""The readers of the program's spans (`perfbench/spans.py`,
`dispatch_ms_per_call`, `h2d_wait_ms_per_img`, `launch_idle_pct` and their
`.b32` twins) on a Chrome trace built by hand.

A 1000 µs window, B 4: two serve calls inside it and a third that the
window's end cuts, device work everywhere but in four gaps: one inside
call 1's `yolox.backbone`, one inside call 2's `yolox.h2d`, one between
the calls (outside `yolox.serve`) and one inside the cut call.
"""

import pytest

from perfbench import cells
from perfbench.trace import WINDOW, TraceView

BATCH = 4
CALLS = [  # (serve, h2d, backbone), µs
    ((100, 300), (110, 150), (160, 260)),
    ((500, 700), (505, 560), (570, 680)),
    ((950, 1100), (952, 955), (958, 1090)),
]
GAPS = [(200, 220), (520, 540), (800, 850), (960, 980)]


def _x(name, cat, start, end):
    return {"ph": "X", "cat": cat, "name": name, "ts": start,
            "dur": end - start, "pid": 1, "tid": 1}


def _events(program_spans=True):
    events = [_x(WINDOW, "user_annotation", 0, 1000)]
    for serve, h2d, backbone in CALLS:
        events.append(_x("perfbench.serve", "user_annotation", *serve))
        if program_spans:
            events += [_x("yolox.serve", "user_annotation", *serve),
                       _x("yolox.h2d", "user_annotation", *h2d),
                       _x("yolox.backbone", "user_annotation", *backbone)]
        events.append(_x("aten::copy_", "cpu_op", h2d[0] + 2, h2d[1]))
    at = 0
    for s, e in GAPS:
        events.append(_x("some_kernel", "kernel", at, s))
        at = e
    events.append(_x("Memcpy HtoD", "gpu_memcpy", at, 1000))
    return events


def _view(program_spans=True):
    info = {"batch": BATCH, "calls": 3, "images": 8, "window_s": 1e-3}
    return TraceView(_events(program_spans), info, {"config": {}})


def read(name, view):
    return cells.module("metrics", name).read(view)


def test_dispatch_ms_per_call():
    # the two whole calls: 200 - 40 and 200 - 55 µs
    assert read("dispatch_ms_per_call", _view()) == pytest.approx(0.1525)


def test_h2d_wait_ms_per_img():
    # 40 + 55 µs over 2 calls x 4 images
    assert read("h2d_wait_ms_per_img", _view()) == \
        pytest.approx(95e-3 / 8)


def test_launch_idle_pct_is_a_part_of_idle_pct():
    view = _view()
    # the gaps in call 1's backbone and in the cut call: 40 of 1000 µs
    assert read("launch_idle_pct", view) == pytest.approx(4.0)
    assert read("idle_pct.offline", view) == pytest.approx(11.0)
    assert read("launch_idle_pct", view) <= read("idle_pct.offline", view)


@pytest.mark.parametrize("name", ["dispatch_ms_per_call",
                                  "h2d_wait_ms_per_img", "launch_idle_pct"])
def test_twins_and_none_without_program_spans(name):
    view = _view()
    twin = cells.module("metrics", f"{name}.b32")
    assert twin.UNIT == cells.module("metrics", name).UNIT
    assert twin.read(view) == read(name, view)
    assert read(name, _view(program_spans=False)) is None


def test_breakdown_names_program_spans():
    """An idle gap where no operator is open is named by the innermost
    program span open at its start."""
    idle = dict(_view().breakdown()["idle_gaps"])
    # call 1's gap and the cut call's, both in a backbone
    assert idle["perfbench.serve > yolox.backbone"] == pytest.approx(40e-6)
    assert idle["perfbench.serve > aten::copy_"] == pytest.approx(20e-6)
    assert idle["outside the program"] == pytest.approx(50e-6)
