"""Readings that set a cell's limits: the numbers compared, for sound runs
of the program and for the control, over many seeds in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control-seeds 4,5,6]

Prints one JSON line per run: {"seed", "side": "program" | "control",
"correct", "check", "counts", "metrics"}. The benchmark's own runs never
run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text):
    return [int(x) for x in text.split(",") if x]


def emit(seed, side, r):
    print(json.dumps({"seed": seed, "side": side, "correct": r["correct"],
                      "check": r["check"], "counts": r["counts"],
                      "metrics": r.get("metrics", {})}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import cells

    cell = cells.load(args.workload)
    traffic = cells.module("traffic", cell["traffic"]["kind"])
    for seed in seeds(args.seeds):
        emit(seed, "program", cells.run(cell, seed, args.seconds, False,
                                        args.device, time.perf_counter()))
    for seed in seeds(args.control_seeds):
        emit(seed, "control", traffic.control(
            traffic.setup(cell, seed, args.device)))


if __name__ == "__main__":
    main()
