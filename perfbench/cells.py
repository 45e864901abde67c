"""Cells found by name, and one run of a cell.

A cell is `perfbench/workloads/<cell>.json`:

    {"config": <name of perfbench/configs/<name>.json>,
     "traffic": {"kind": <name of perfbench/traffic/<kind>.py>, ...},
     "chips": 1,
     "end_to_end": {<metric>: <unit>, ...},      # --trace 0 (see run)
     "per_layer": [<metric>, ...],               # --trace 1
     "trace_seconds": <length of the traced window>,
     "margins": {...},                           # serving cells
     "limits": {<number compared>: <limit>, ...},
     "why": "..."}

A configuration names its architecture (`"arch"`), the module
`perfbench/archs/<arch>.py` that builds its plain reference and the
program's network and holds its seeded-weight rules (`arch`).

A traffic module has `setup(cell, seed, device) -> session`,
`window(session, seconds) -> dict` (its end-to-end readings under
"metrics", and what the per-layer readers read) and `check(session,
window) -> {"correct", "check", "attempted", "failed", ...}`, which frees
the program before the reference runs. A per-layer metric
`perfbench/metrics/<metric>.py` has `UNIT` and `read(view) -> value or
None` (`perfbench/trace.py::TraceView`).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"perfbench: no {kind[:-1]} {name!r} ({path})")
    return json.loads(path.read_text())


def load(name: str, workload: dict = None, config: dict = None) -> dict:
    """The cell `name` with its configuration. A test may hand the two
    dicts in place of the files."""
    cell = dict(workload or _json("workloads", name))
    cell["name"] = name
    path = HERE / "configs" / f"{cell['config']}.json"
    cell["config"] = dict(config or _json("configs", cell["config"]))
    arch(cell["config"], path)
    return cell


def arch(config: dict, where="a configuration"):
    """`perfbench/archs/<arch>.py` for the configuration's `arch`: its
    `reference(config, quant, device)`, `program(config, state, device,
    dtype)`, `STEM`, `RESIDUAL` and `small(config, size)`. There is no
    default: a configuration with no `arch`, or one with no module, fails
    with `where` (the file's path) and the architectures that exist."""
    name = config.get("arch")
    if not isinstance(name, str) or \
            not (HERE / "archs" / f"{name}.py").is_file():
        known = sorted(p.stem for p in (HERE / "archs").glob("*.py"))
        raise SystemExit(f"perfbench: {where} names arch {name!r}; the "
                         f"architectures are {', '.join(known)}")
    return module("archs", name)


def module(kind: str, name: str):
    """`perfbench/<kind>/<name>.py`, loaded by path (names may hold dots)."""
    key = f"perfbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"perfbench: no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    traffic = module("traffic", cell["traffic"]["kind"])
    cuda = torch.device(device).type == "cuda"
    session = traffic.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        length = min(seconds, cell["trace_seconds"])
        setup_s = time.perf_counter() - t_start
        with profile(activities=acts) as prof:
            win = traffic.window(session, length)
        from perfbench.trace import chrome_events

        events = chrome_events(prof)
    else:
        setup_s = time.perf_counter() - t_start
        win = traffic.window(session, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": device_info(device, peak)}
    if trace:
        from perfbench.trace import TraceView

        view = TraceView(events, win, cell)
        del events, prof
        for name in cell["per_layer"]:
            reader = module("metrics", name)
            value = reader.read(view)
            if value is not None:
                result["metrics"][name] = {"value": value,
                                           "unit": reader.UNIT}
        result["device"]["busy_s"] = view.busy_s
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
        del view
    else:
        readings = dict(win["metrics"], setup_s=setup_s)
        for name, unit in cell["end_to_end"].items():
            # `<reading>.<suffix>` reports the traffic's `<reading>` under
            # a bound of its own
            value = readings.get(name, readings.get(name.split(".")[0]))
            result["metrics"][name] = {"value": value, "unit": unit}
    t_check = time.perf_counter()
    outcome = traffic.check(session, win)
    check_s = time.perf_counter() - t_check
    result["correct"] = bool(outcome["correct"])
    result["attempted"] = int(outcome["attempted"])
    result["failed"] = int(outcome["failed"])
    result["counts"] = outcome.get("counts", {})
    result["extra"] = dict(win.get("extra", {}), check_s=check_s)
    result["check"] = outcome["check"]  # the last key, as the check wants
    return result


def print_check(result: dict) -> None:
    """Each number compared beside its limit, as the last lines of standard
    error."""
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr)
