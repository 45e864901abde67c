"""launch_idle_pct: the device starved by the host's launches. The idle
gaps of the traced window (`TraceView.idle_gaps`) that begin while a
`yolox.serve` span is open and no `yolox.h2d` span is, summed, as a share
of the window; a part of `idle_pct.offline`. None where the program
records no `yolox.serve` span."""

from perfbench import spans

UNIT = "%"


def read(view):
    serve = spans.program_spans(view, spans.SERVE)
    if not serve or view.window_s <= 0:
        return None
    in_serve = spans.OpenSpans(serve)
    in_copy = spans.OpenSpans(spans.program_spans(view, spans.H2D))
    idle = sum(t - s for s, t in view.idle_gaps()
               if in_serve.at(s) and not in_copy.at(s))
    return 100.0 * idle / 1e9 / view.window_s
