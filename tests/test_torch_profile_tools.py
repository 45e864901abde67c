"""The port's device-free profiling tools against the JAX package's on
the CPU, and the trace parsing of the profilers:

- `scripts/torch_serve_traffic_model.py`: the conv census of the port's
  serving forward equals JAX's `serve_traffic_model.conv_census(model,
  batch, lane_fold=False)` row for row, exactly (count, logical bytes and
  FLOPs of each (Cin, Cout, H, depthwise) key, and the totals): yolox-s
  640 px B 1 bf16 (31 rows, 83 convs, 26.6855424 GFLOP, 0.14786 GB),
  nano (its depthwise rows), and yolox-s B 2 float32 against JAX's bf16
  census (JAX takes none in float32: the counts are the same, bytes scale
  with the batch and the item size, FLOPs with the batch); `main` prints
  the totals and the bound img/s at the H100's peaks;
- `scripts/torch_trace_report.py` on a hand-built Chrome trace (kernels,
  a copy and a set on known device tracks, CPU ops, Python frames and a
  runtime call that must not count), given as a file, as `.gz` and as a
  directory: exactly the expected lines; a real CPU torch.profiler export
  and a Trainer-named `trace_rank0.json` parse, with no device track;
- `scripts/torch_profile_augment.py`: kernels placed at the innermost
  package frame around their launch (by correlation id, the launch
  plumbing skipped) on a hand-built trace, and `main` on the CPU (B 2,
  128 px, 1 iteration) prints the engine row and a per-op table
  attributed to files under `yolox_tpu_torch/`;
- `scripts/torch_eval_memory_ab.py` and JAX's `eval_memory_ab.py` at
  20 000 detections on 50 images give the same AP in both modes, and
  each child's peak RSS is its own under a caller ~1 GB larger;
- every tool's H100 peaks equal `chip_smoke.H100_*`, and importing the
  six tools (and taking a census) pulls in no `jax`, `yolox_tpu` or
  `bench` module.
"""

import gzip
import json
import resource
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
sys.path.insert(0, str(SCRIPTS))
try:
    import serve_traffic_model as jstm
    import torch_eval_memory_ab as tem
    import torch_profile_augment as tpa
    import torch_profile_serve as tps
    import torch_profile_train as tpt
    import torch_serve_traffic_model as ttm
    import torch_trace_report as ttr
finally:
    sys.path.remove(str(SCRIPTS))

TOOLS = ("torch_serve_traffic_model", "torch_profile_serve",
         "torch_trace_report", "torch_profile_train",
         "torch_profile_augment", "torch_eval_memory_ab")

_JAX_CENSUS = {}


def _jax_census(model):
    """JAX's census at B 1 (bf16), once a model: ({key: (n, logical,
    FLOPs)}, logical, FLOPs, size)."""
    if model not in _JAX_CENSUS:
        rows, logical, _, flops, size = jstm.conv_census(model, 1, False)
        _JAX_CENSUS[model] = ({k: (v[0], v[1], v[3]) for k, v in rows.items()},
                              logical, flops, size)
    return _JAX_CENSUS[model]


@pytest.mark.parametrize("model,batch,dtype", [
    ("s", 1, "bfloat16"), ("nano", 1, "bfloat16"), ("s", 2, "float32")])
def test_census_equals_jax_row_for_row(model, batch, dtype):
    rows, logical, flops, size = _jax_census(model)
    scale = batch * (2 if dtype == "float32" else 1)  # JAX's is bf16, B 1
    got = ttm.conv_census(model, batch, dtype)
    assert got["size"] == size
    assert set(got["rows"]) == set(rows)
    for key, (n, lg, fl) in rows.items():
        assert got["rows"][key] == [n, lg * scale, fl * batch], key
    assert got["logical"] == logical * scale
    assert got["flops"] == flops * batch
    parts = got["parts"]
    assert parts["backbone"][1] + parts["head"][1] == got["flops"]
    if model == "s" and batch == 1:
        assert len(rows) == 31 and sum(r[0] for r in rows.values()) == 83
        assert got["flops"] == 26_685_542_400
        assert got["logical"] == 147_860_000
        assert got["rows"][(3, 32, 640, False)][0] == 1  # the stem, as JAX
    if model == "nano":
        assert any(k[3] for k in got["rows"])


def test_traffic_main_prints_totals_and_bounds(capsys):
    res = ttm.main(["--model", "s", "--batch", "1"])
    out = capsys.readouterr().out
    assert "totals: 31 shapes, 83 convs, logical 0.14786 GB, " \
           "26.6855424 GFLOP" in out
    assert res["hbm_img_per_s"] == 1 / (147_860_000 / chip_smoke.H100_HBM_BYTES)
    assert res["flop_img_per_s"] == 1 / (26_685_542_400
                                         / chip_smoke.H100_BF16_FLOPS)
    assert f"{res['hbm_img_per_s']:.0f} img/s" in out
    assert res["peaks"] == {"hbm_bytes_per_s": chip_smoke.H100_HBM_BYTES,
                            "flops_per_s": chip_smoke.H100_BF16_FLOPS}
    assert ttm.peak_flops("float32") == chip_smoke.H100_F32_FLOPS
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(res))


def _hand_trace():
    """A Chrome trace with device events on pid 0 (streams 7 and 8) and
    host events on pid 100 that the report must not count."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0,
         "args": {"name": "python"}}]
    dev = [
        {"ph": "X", "cat": "kernel", "name": "kA", "pid": 0, "tid": 7,
         "ts": 0, "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "kB", "pid": 0, "tid": 7,
         "ts": 400, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "kA", "pid": 0, "tid": 7,
         "ts": 600, "dur": 300},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 1000, "dur": 200},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0,
         "tid": 8, "ts": 1300, "dur": 100}]
    host = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 100,
         "tid": 1, "ts": 0, "dur": 5000},
        {"ph": "X", "cat": "python_function", "name": "x.py(1): f",
         "pid": 100, "tid": 1, "ts": 0, "dur": 9000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 100, "tid": 1, "ts": 10, "dur": 5}]
    return {"traceEvents": meta + host + dev}


REPORT = """device tracks: ['GPU 0 / stream 7', 'GPU 0 / 8']
total device op time: 1.000 ms  (500.0 us/iter)
    0.600 ms   60.0%     300.0 us/iter  kA
    0.200 ms   20.0%     100.0 us/iter  Memcpy HtoD
    0.100 ms   10.0%      50.0 us/iter  Memset
    0.100 ms   10.0%      50.0 us/iter  kB
"""


@pytest.mark.parametrize("form", ["file", "gz", "dir"])
def test_trace_report_on_a_hand_built_trace(tmp_path, capsys, form):
    trace = _hand_trace()
    if form == "gz":
        path = tmp_path / "t.pt.trace.json.gz"
        with gzip.open(path, "wt") as f:
            json.dump(trace, f)
    else:
        path = tmp_path / "trace_rank0.json"
        path.write_text(json.dumps(trace))
    rep = ttr.main([str(tmp_path if form == "dir" else path),
                    "--iters", "2"])
    out = capsys.readouterr().out
    assert out.split("{")[0] == REPORT
    assert rep["total_ms"] == 1.0 and rep["us_per_iter"] == 500.0
    assert [op["name"] for op in rep["ops"]] == ["kA", "Memcpy HtoD",
                                                 "Memset", "kB"]
    assert [op["share"] for op in rep["ops"]] == [0.6, 0.2, 0.1, 0.1]
    assert [op["count"] for op in rep["ops"]] == [2, 1, 1, 1]
    top = ttr.report(ttr.load_events(str(path)), top=1)
    assert [op["name"] for op in top["ops"]] == ["kA"]
    assert top["us_per_iter"] is None and top["total_ms"] == 1.0


def _cpu_profile(path):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.nn.functional.silu(x @ x).sum()
    prof.export_chrome_trace(str(path))


@pytest.mark.parametrize("name", ["cpu.pt.trace.json", "trace_rank0.json"])
def test_trace_report_reads_a_cpu_export(tmp_path, capsys, name):
    _cpu_profile(tmp_path / name)
    rep = ttr.main([str(tmp_path), "--iters", "3"])
    out = capsys.readouterr().out
    assert out.startswith("no device track found")
    assert rep["tracks"] == [] and rep["ops"] == []
    assert rep["total_ms"] == 0.0


def test_augment_attribution_by_correlation():
    pkg = "yolox_tpu_torch/ops/"
    frames = [("warp.py(10): outer", 0, 1000),
              ("shear_kernel.py(50): shear_xy", 100, 200),
              ("_build.py(150): launch", 150, 50)]
    events = [{"ph": "X", "cat": "python_function", "name": pkg + n,
               "pid": 100, "tid": 1, "ts": ts, "dur": dur}
              for n, ts, dur in frames]
    events.append({"ph": "X", "cat": "python_function", "pid": 100,
                   "tid": 1, "name": "torch/nn/functional.py(5): silu",
                   "ts": 400, "dur": 100})
    for corr, ts, cat in ((1, 160, "cuda_runtime"), (2, 450, "cuda_runtime"),
                          (3, 2000, "cuda_runtime"), (4, 120, "cuda_driver")):
        events.append({"ph": "X", "cat": cat, "name": "launch", "pid": 100,
                       "tid": 1, "ts": ts, "dur": 1,
                       "args": {"correlation": corr}})
    for corr, name, dur in ((1, "shear_xy_kernel", 70), (2, "silu", 30),
                            (3, "late", 10), (4, "shear_xy_kernel", 5),
                            (99, "orphan", 1)):
        events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                       "tid": 7, "ts": 5000, "dur": dur,
                       "args": {"correlation": corr}})
    rows = tpa.attribute(events, iters=1)
    assert [(r["name"], r["frame"], r["ms"], r["count"]) for r in rows] == [
        ("shear_xy_kernel", pkg + "shear_kernel.py(50): shear_xy", 0.075, 2),
        ("silu", pkg + "warp.py(10): outer", 0.03, 1),
        ("late", "?", 0.01, 1), ("orphan", "?", 0.001, 1)]
    assert all(r["device"] for r in rows)


def test_augment_main_attributes_ops_on_the_cpu(tmp_path, capsys):
    res = tpa.main(["--device", "cpu", "--batch", "2", "--size", "128",
                    "--iters", "1", "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    assert "full engine:" in out and "not measured" in out
    for k in ("events_ms", "device_ms", "kernel_ms", "img_per_s", "busy"):
        assert res[k] is None
    ops = res["ops"]
    assert len(ops) == 25 and not any(op["device"] for op in ops)
    assert ops[0]["frame"].startswith("yolox_tpu_torch/")
    attributed = sum(op["ms"] for op in ops
                     if op["frame"].startswith("yolox_tpu_torch/"))
    assert attributed >= 0.9 * sum(op["ms"] for op in ops)
    assert "yolox_tpu_torch/ops/warp.py" in out
    assert Path(res["trace"]).is_file()


def test_eval_memory_ab_equals_jax():
    # a caller whose peak RSS is ~1 GB larger than a child's: each child
    # still reads its own (`ru_maxrss` is carried across exec)
    ballast = np.ones(125_000_000)
    got = tem.run(20_000, 50)
    caller_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    del ballast
    out = subprocess.run(
        [sys.executable, str(SCRIPTS / "eval_memory_ab.py"), "--dets",
         "20000", "--images", "50"], capture_output=True, text=True,
        check=True, cwd=REPO).stdout
    want = [json.loads(line) for line in out.strip().splitlines()]
    assert [r["mode"] for r in got] == ["columnar", "dict"]
    for g, w in zip(got, want):
        assert "error" not in g, g
        assert g["mode"] == w["mode"] and g["ap"] == w["ap"]
        assert set(g) == set(w)
    assert got[0]["ap"] == got[1]["ap"] > 0
    assert all(g["peak_host_rss_gb"] < caller_gb - 0.5 for g in got), (
        got, caller_gb)


def test_peaks_and_imports():
    for mod in (ttm, tps, tpt, tpa):
        assert mod.H100_BF16_FLOPS == chip_smoke.H100_BF16_FLOPS
        assert mod.H100_F32_FLOPS == chip_smoke.H100_F32_FLOPS
        assert mod.H100_HBM_BYTES == chip_smoke.H100_HBM_BYTES
    code = (
        "import sys; sys.path.insert(0, 'scripts')\n"
        + "".join(f"import {t}\n" for t in TOOLS)
        + "torch_serve_traffic_model.conv_census('nano', 1)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'yolox_tpu', 'bench')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO).stdout
    assert out.strip() == "[]"
