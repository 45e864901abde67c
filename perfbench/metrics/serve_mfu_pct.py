"""serve_mfu_pct: the serving step's share of the card's bf16 peak.

The reference network's conv FLOPs per image at the input size
(`perfbench/flops.py`) times the images whose detections reached the host
in the traced window, over the window's seconds, over 989e12."""

from perfbench import flops, peaks

UNIT = "%"


def read(view):
    images = view.info.get("images")
    if not images:
        return None
    rate = images / view.info["window_s"]
    return 100.0 * flops.config_flops(view.cell["config"]) * rate \
        / peaks.BF16_FLOPS
