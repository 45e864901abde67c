"""Small cells for the CPU tests: a cell's own files with the model cut by
its architecture's `small` (`perfbench/archs/<arch>.py`) to a small input,
and the traffic cut to match, handed to `cells.load` as dicts (no file of
the benchmark is edited or added)."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def small_config(name: str, size: int = 160):
    """The configuration `name` as its architecture cuts it, at `size` px,
    in float32."""
    from perfbench import cells

    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return dict(cells.arch(cfg).small(cfg, size), dtype="float32")


def small_cell(name: str, size: int = 256):
    from perfbench import cells

    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cfg = small_config(wl["config"], size)
    t = wl["traffic"]
    scale = size / 640
    if t["kind"] == "offline_batches":
        t.update(batch=4, pool_batches=2, compare_extra=1, warmup_calls=1,
                 shapes=[[int(h * scale), int(w * scale), 1]
                         for h, w, _ in t["shapes"][:4]])
    return cells.load(name, wl, cfg)
