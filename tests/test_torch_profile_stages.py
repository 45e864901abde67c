"""The port's serve profiler (`scripts/torch_profile_serve.py`) against
the JAX package on the CPU:

- the three serve stages' checksums (backbone, + raw head, full serve)
  equal the JAX tool's checksums computed with the JAX package's
  `backbone`, `head.forward_raw` and `serve` (nano at 128 px, float32,
  B 2, weights carried across with `state_dict_from_jax`, the prediction
  convs spread so that the full serve keeps detections: its checksum is
  a detection's box, not 0), at rtol 1e-4 / atol 1e-5 (float32 convs in
  another order);
- `main` of the serve profiler on the CPU prints all three rows with
  every field (times "not measured"), its conv FLOPs those of the
  traffic model's census, its bytes counted, and writes a trace;
- `count_bytes` counts a kernel wrapper by its arguments and results,
  and an aten op by its inputs and outputs.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)
from chip_smoke import spread_scores

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))
try:
    import torch_profile_serve as tps
finally:
    sys.path.remove(str(SCRIPTS))

SERVE_FIELDS = ("stage", "checksum", "events_ms", "device_ms", "kernel_ms",
                "launches",
                "kernel_gbytes", "img_per_s", "busy", "gflop", "gbytes",
                "flop_bound_ms", "byte_bound_ms", "mfu_pct", "hbm_pct")
RTOL, ATOL = 1e-4, 1e-5


def _jax_serve_checksums(jmod, x, max_det, nms_thre):
    """The JAX tool's three checksums (`scripts/profile_serve.py`)."""
    p, xin = jmod.params, jnp.asarray(x)
    fpn = jmod.backbone(p["backbone"], xin)
    backbone = sum(float(jnp.sum(f[:, 0, 0, :4].astype(jnp.float32)))
                   for f in fpn)
    raw, _, _ = jmod.head.forward_raw(p["head"], fpn)
    head = float(jnp.sum(raw[:, 0, :4].astype(jnp.float32)))
    dets, valid = jmod.serve(p, xin, conf_thre=0.5, nms_thre=nms_thre,
                             class_agnostic=False, max_det=max_det)
    return [backbone, head, float(jnp.sum(dets[:, 0, 0]))], np.asarray(valid)


def test_serve_stage_checksums_equal_jax():
    from yolox_tpu import YoloxConfig as JConfig
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu_torch import YoloxConfig, YoloxModule
    from yolox_tpu_torch.models.weights import (
        state_dict_from_jax,
        state_dict_to_jax,
    )

    cfg = YoloxConfig.get_named_config("yolox_nano")
    jmod = JModule.from_config(JConfig.get_named_config("yolox_nano"),
                               rng_seed=3)
    module = YoloxModule.from_config(cfg, device="cpu")
    module.load_params(state_dict_from_jax(jmod.params))
    x = tps.serve_input(2, 128, "cpu")
    spread_scores(module, x, std=2.0, bias=0.0)
    jmod.load_params(jax.tree.map(jnp.asarray,
                                  state_dict_to_jax(module.state_dict())))

    got = [float(fn()) for _, _, fn in
           tps.serve_stages(module, x, 256, cfg.nmsthre)]
    want, valid = _jax_serve_checksums(jmod, x.numpy(), 256, cfg.nmsthre)
    assert valid[:, 0].all()  # the full serve checks a real detection
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_serve_main_prints_every_stage_on_the_cpu(tmp_path, capsys):
    from torch_serve_traffic_model import conv_census

    res = tps.main(["--device", "cpu", "--model", "nano", "--batch", "2",
                    "--iters", "1", "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    stages = res["stages"]
    assert [s["stage"] for s in stages] == [
        "backbone", "backbone+head raw", "full serve (+decode+NMS)"]
    for s in stages:
        assert set(SERVE_FIELDS) <= set(s), s
        assert s["stage"] in out
        # no device, no time: nothing is written under a device metric
        for k in ("events_ms", "device_ms", "kernel_ms", "img_per_s",
                  "busy", "mfu_pct", "hbm_pct"):
            assert s[k] is None
        assert np.isfinite(s["checksum"]) and s["gbytes"] > 0
        assert s["launches"] == dict.fromkeys(s["launches"], 0)
    assert out.count("not measured") >= 3
    census = conv_census("nano", 2, "bfloat16")
    parts = census["parts"]
    exact = dict(rel=1e-12, abs=0)
    assert stages[0]["gflop"] * 1e9 == pytest.approx(parts["backbone"][1],
                                                     **exact)
    assert stages[2]["gflop"] * 1e9 == pytest.approx(
        parts["backbone"][1] + parts["head"][1], **exact)
    # every stage moves at least its convs' logical bytes; the head adds
    assert stages[0]["gbytes"] * 1e9 >= parts["backbone"][0]
    assert stages[1]["gbytes"] > stages[0]["gbytes"]
    assert stages[0]["flop_bound_ms"] == pytest.approx(
        1e3 * parts["backbone"][1] / tps.H100_BF16_FLOPS, **exact)
    assert stages[0]["byte_bound_ms"] == pytest.approx(
        1e3 * stages[0]["gbytes"] * 1e9 / tps.H100_HBM_BYTES, **exact)
    assert Path(res["trace"]).is_file()


def test_count_bytes_counts_kernels_by_their_arguments():
    """Inside a kernel wrapper no aten op counts; its arguments and
    results do. An elementwise op counts its input and output once, a view
    nothing, `copy_` its source and destination."""
    from yolox_tpu_torch.ops import nms

    x = torch.zeros(4, 8)
    with tps.count_bytes() as acc:
        y = x + 1
        y.view(32)
        y.copy_(x)
    assert acc["bytes"] == 2 * 128 + 2 * 128 and acc["kernel_bytes"] == 0
    boxes = torch.rand(1, 16, 4) * 100
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 16, dtype=torch.bool)
    with tps.count_bytes() as acc:
        keep = nms.nms_keep(boxes, valid, 0.5)
    assert acc["bytes"] == acc["kernel_bytes"] == 16 * 16 + 16 + 16
    assert keep.shape == (1, 16)
