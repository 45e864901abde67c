"""k1_roofline_pct: the stem kernel K1's share of its roofline.

The least time of one call, the larger of its bytes (`flops.stem_bytes`:
the uint8 image in, the stem map out in the serving dtype, the folded
weights) at 3.35e12 B/s and its FLOPs at 989e12, over K1's device time a
call: the kernels named `stem_*_kernel` in the trace, summed over the
launches of one call. None where no such kernel ran."""

from perfbench import flops, peaks

UNIT = "%"
KERNEL = r"stem_\w+_kernel"


def read(view):
    seconds, launches = view.device_time(KERNEL)
    calls = view.info.get("calls")
    if not launches or not calls:
        return None
    per_call_launches = max(1, round(launches / calls))
    per_call = seconds / launches * per_call_launches
    cfg, batch = view.cell["config"], view.info["batch"]
    itemsize = 2 if cfg["dtype"] == "bfloat16" else 4
    least = max(flops.stem_bytes(cfg, batch, itemsize) / peaks.HBM_BYTES_PER_S,
                flops.stem_flops(cfg, batch) / peaks.BF16_FLOPS)
    return 100.0 * least / per_call
