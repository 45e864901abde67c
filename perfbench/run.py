"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is `perfbench/workloads/<cell>.json`. It names its configuration
(`perfbench/configs/<config>.json`), its traffic (`perfbench/traffic/
<kind>.py` with the file's parameters) and its metrics; the metrics of
`--trace 1` are read by `perfbench/metrics/<metric>.py`. Nothing here
knows a cell, a model or a metric by name.

A run: set-up (weights and inputs from the seed, the program built and
warmed up on every shape the traffic uses), the measured window of
`--seconds` (with `--trace 1` a window of the cell's `trace_seconds` under
the profiler), the device's peak memory, then the check of the window's
outputs against the plain reference (`perfbench/reference/`), printed as
the last lines of standard error and as the last key of the result line,
the last line of standard output. With no CUDA device, or fewer than the
cell asks for, it prints no result and exits 2; if JAX or the JAX package
was loaded, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a run writes stays inside the checkout, at fixed paths
CACHE = ROOT / ".perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "yolox_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`yolox_tpu_torch` is not `yolox_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = cells.run(cell, args.seed, args.seconds, bool(args.trace),
                       device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    cells.print_check(result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
