"""The benchmark's files: every cell resolves by name, names and units
keep to the allowed characters, BENCHMARK.json agrees with the cells,
every configuration names an architecture that has a module, the FLOP
counts match the published ones, the seeded weights' rules hold, no
module of the benchmark imports JAX or the JAX package (the reference
nothing of the program), and only `archs/` imports an architecture's
reference or the program's model classes."""

import ast
import hashlib
import json
import re
from pathlib import Path

import pytest

from perfbench import cells, flops, weights

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))
CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))
ARCHS = sorted(p.stem for p in (HERE / "archs").glob("*.py"))


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


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


@pytest.mark.parametrize("name", CONFIGS)
def test_config_names_its_arch(name):
    path = HERE / "configs" / f"{name}.json"
    cfg = _config(name)
    arch = cells.arch(cfg, path)
    assert callable(arch.reference) and callable(arch.program)
    assert callable(arch.small)
    assert callable(arch.STEM.search) and callable(arch.RESIDUAL.search)
    cut = arch.small(cfg, 64)
    assert cut["input_size"] == [64, 64] and cut["arch"] == cfg["arch"]


@pytest.mark.parametrize("arch", [None, "no_such_arch"])
def test_unknown_arch_fails_with_path_and_archs(arch):
    name = WORKLOADS[0]
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cfg = _config(wl["config"])
    cfg.pop("arch")
    if arch is not None:
        cfg["arch"] = arch
    with pytest.raises(SystemExit) as err:
        cells.load(name, wl, cfg)
    message = str(err.value)
    assert str(HERE / "configs" / f"{wl['config']}.json") in message
    assert repr(arch) in message
    assert all(a in message for a in ARCHS)


@pytest.mark.parametrize("name,published", [
    ("yolox_s", 26.8e9), ("yolox_x", 281.9e9)])
def test_flops_match_published(name, published):
    got = flops.config_flops(_config(name))
    assert abs(got - published) / published < 0.01


@pytest.mark.parametrize("name,want", [
    ("yolox_s", 26_685_542_400), ("yolox_x", 281_409_792_000)])
def test_config_flops_exact(name, want):
    """The conv FLOPs an image that the harness counted before a
    configuration named its architecture."""
    assert flops.config_flops(_config(name)) == want


# sha256 of json.dumps([[key, shape, multiplier, offset, kind, zero_sum],
# ...]) over the reference state dict's floating keys in draw order, and
# their count, computed with the harness before a configuration named its
# architecture (`weights._scale` and the zero-sum test of `seeded_state`
# there, on `reference/yolox.py::build` on the meta device)
INIT_DIGESTS = {
    "yolox_s": (388, "c53e47cc3662bdf2d039b1e12089ff6cf1cb9c29edd4e953"
                     "4c71e53f4b6b7196"),
    "yolox_x": (748, "46b47ccb6d6e2aab8ac026869648b1732d53613629a5a7a5"
                     "3afd8655b7f266a4"),
}


@pytest.mark.parametrize("name", sorted(INIT_DIGESTS))
def test_init_rules_unchanged(name):
    cfg = _config(name)
    arch = cells.arch(cfg)
    shapes = weights.state_shapes(arch.reference(cfg, device="meta"))
    rows = [[key, list(shape),
             *weights._scale(key, shape, cfg["init"], arch)]
            for key, (shape, dt) in shapes.items() if dt.is_floating_point]
    digest = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    assert (len(rows), digest) == INIT_DIGESTS[name]


def _imports(path: Path):
    """Every module a file imports; `from m import n` yields m and m.n."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


SOURCES = sorted(str(p.relative_to(HERE)) for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_imports(rel):
    tops = {name.split(".")[0] for name in _imports(HERE / rel)}
    assert not tops & {"jax", "jaxlib", "flax", "yolox_tpu"}
    if rel.startswith("reference"):
        assert "yolox_tpu_torch" not in tops


# an architecture's reference and the program's model classes, which only
# `archs/<arch>.py` builds
ARCH_ONLY = tuple(f"perfbench.reference.{a}" for a in ARCHS) + (
    "yolox_tpu_torch.models",)
CORE = [rel for rel in SOURCES if not rel.startswith(("archs/", "tests/"))]


@pytest.mark.parametrize("rel", CORE)
def test_only_archs_import_architectures(rel):
    for name in _imports(HERE / rel):
        assert not any(name == m or name.startswith(m + ".")
                       for m in ARCH_ONLY), (rel, name)
