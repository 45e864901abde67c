"""h2d_wait_ms_per_img: how long the host is held by the host-to-device
copy. The `yolox.h2d` spans inside the `yolox.serve` spans that lie wholly
inside the traced window, summed, in milliseconds, over those calls times
the batch; beside `h2d_ms_per_img`, the copy's device time. None where the
program records no such span."""

from perfbench import spans

UNIT = "ms/img"


def read(view):
    calls = spans.serve_calls(view)
    batch = view.info.get("batch")
    if not calls or not batch:
        return None
    return sum(copy for _, _, copy in calls) / 1e6 / (len(calls) * batch)
