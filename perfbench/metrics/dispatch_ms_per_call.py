"""dispatch_ms_per_call: the host's time to enqueue one serve call, copy
left out. Each `yolox.serve` span of the program lying wholly inside the
traced window, less the `yolox.h2d` span inside it, in milliseconds,
averaged over those spans (`perfbench/spans.py`). None where the program
records no such span."""

from perfbench import spans

UNIT = "ms"


def read(view):
    calls = spans.serve_calls(view)
    if not calls:
        return None
    return sum(e - s - copy for s, e, copy in calls) / len(calls) / 1e6
