"""The benchmark's files: every cell resolves by name, names and units
keep to the allowed characters, BENCHMARK.json agrees with the cells, the
FLOP counts match the published ones, and no module of the benchmark
imports JAX or the JAX package (the reference nothing of the program)."""

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import cells, flops

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_resolves(name):
    cell = cells.load(name)
    assert NAME.match(name) and NAME.match(cell["traffic"]["kind"])
    traffic = cells.module("traffic", cell["traffic"]["kind"])
    for fn in ("setup", "window", "check", "control"):
        assert callable(getattr(traffic, fn))
    for metric, unit in cell["end_to_end"].items():
        assert NAME.match(metric) and UNIT.match(unit)
    assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) >= 2
    assert cell["per_layer"]
    for metric in cell["per_layer"]:
        reader = cells.module("metrics", metric)
        assert NAME.match(metric) and UNIT.match(reader.UNIT)
        assert callable(reader.read)
    assert cell["chips"] in (1, 4)
    assert 0 < len(cell["why"]) <= 200 and "\n" not in cell["why"]


def test_benchmark_json_agrees_with_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layer = {m["name"]: m for m in bench["per_layer"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        raw = json.loads((HERE / "workloads" / f"{w['name']}.json")
                         .read_text())
        assert w["config"] == raw["config"] and w["config"] in configs
        assert w["chips"] == cell["chips"] and w["traffic"] == \
            cell["traffic"]["kind"]
        for metric, unit in cell["end_to_end"].items():
            assert e2e[metric]["unit"] == unit
            assert w["name"] in e2e[metric].get("workloads", [w["name"]])
        for metric in cell["per_layer"]:
            m = layer[metric]
            assert m["unit"] == cells.module("metrics", metric).UNIT
            assert m["moves"] in cell["end_to_end"]
            assert w["name"] in m["workloads"]
    for m in list(e2e.values()) + list(layer.values()):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in layer.values():
        for cell_name in m["workloads"]:
            assert m["moves"] in cells.load(cell_name)["end_to_end"]


@pytest.mark.parametrize("depth,width,published", [
    (0.33, 0.5, 26.8e9), (1.33, 1.25, 281.9e9)])
def test_flops_match_published(depth, width, published):
    got = flops.conv_flops(depth, width, 80, 640, 640)
    assert abs(got - published) / published < 0.01


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


SOURCES = sorted(str(p.relative_to(HERE)) for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_imports(rel):
    tops = {name.split(".")[0] for name in _imports(HERE / rel)}
    assert not tops & {"jax", "jaxlib", "flax", "yolox_tpu"}
    if rel.startswith("reference"):
        assert "yolox_tpu_torch" not in tops
