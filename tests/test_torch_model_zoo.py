"""yolox-tiny, -m, -l and -x through the port against the JAX package, on
the CPU, at full width and depth (the models whose only check before was
the config's equality).

Weights come from each package's seeded init (bit-equal:
`tests/test_torch_serve.py::test_seeded_init_equals_jax`); for serving, the
port's prediction convs are then rescaled (`chip_smoke.spread_scores`) and
the whole state dict moved to JAX, so scores are decisive. Inputs are
numpy-seeded uint8 frames. Tolerances:

- the eval forward's raw head outputs (f32, 128 px, B 2): each level
  within `RAW_TOL` of its largest |entry| (the frameworks sum the convs in
  other orders; the rows are pre-decode, so reg, obj and cls differences
  stay at rounding size through the ~100-170 convs);
- `serve` on uint8 frames: `assert_dets_match`'s rtol 1e-4 / atol 1e-2,
  `valid` exact, at a threshold in a gap of JAX's scores, as
  `tests/test_torch_yolov3.py` holds yolov3;
- the float32 train step of tiny and m (128 px, B 2), `fused_bwd` off
  and on, from one JAX state: `tests/test_torch_train.py`'s float32
  tolerances (losses rtol 1e-4, BN statistics rtol 1e-4 / atol 1e-5;
  updates, momentum and EMA within 1e-3 of the largest entry of their
  kind: 1-ulp conv differences grow ~1e3x through train-mode BN; at 64
  px, where the deepest train-mode BN normalizes 2x2 maps, m's cls_loss
  parts from JAX's by 1.2e-4);
- int8 HBM serving of yolox-l (128 px, JAX's table through
  `qtab_from_jax`): `tests/test_torch_quant.py`'s checks, raw outputs at
  `HBM_RMS_TOL` of their spread (its 1.2e-2 is for narrower models) and
  max 3e-2; detections row by row, a label
  free to differ on a tenth of the rows), rows within the row score
  tolerance of the threshold free to go unpaired (phase 11's rule);
- phase 18 of `chip_smoke.py` rehearsed on the CPU (`chip_smoke.CARD =
  "cpu"`, counting wrappers in the kernels' place, each model at full
  width, B 1, 64 px), so a fault in the phase's own code shows before a
  chip call is spent on it; its bounds hold there but for the fused step
  against autograd, whose float32 comparison means nothing at 64 px and
  B 1 (`_rehearsal`).
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    INT8_LABEL_FLIPS,
    INT8_MIN_DETS,
    assert_dets_match,
    gap_threshold,
    match_rows_free_labels,
    spread_scores,
)
from test_torch_quant import _jax_serve, _port_raw, _scores
from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu import YoloxModule as JModule
from yolox_tpu.core import init_train_state as j_init
from yolox_tpu.core import make_train_step as j_make
from yolox_tpu.models.blocks import EVAL_CTX
from yolox_tpu.ops.nms import postprocess_fused_levels as jpostprocess
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.core import init_train_state, make_train_step
from yolox_tpu_torch.models.weights import (
    nested_to_flat,
    qtab_from_jax,
    state_dict_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

# the four models and their weight seeds
ZOO = {"yolox_tiny": 41, "yolox_m": 42, "yolox_l": 43, "yolox_x": 44}
SIZE = 128          # eval forward, serve and int8
TRAIN_SIZE = 128
RAW_TOL = 1e-4
MAX_DET = 64
# yolox-l's int8 HBM raw outputs against JAX's, rms over each level's
# spread: the HBM mode's prediction convs run in bf16 in both packages,
# and XLA and oneDNN round their 256-channel sums apart by a few bf16 ulps
# at levels 1 and 2 (measured 0.016 / 0.020; level 3 bit-equal, and both
# packages equally far from the float outputs, 0.027 / 0.031 / 0.004).
# tests/test_torch_quant.py allows 1.2e-2 on its narrower models, whose
# outputs spread wider against a bf16 ulp
HBM_RMS_TOL = 2.5e-2


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(the port's module with spread scores, uint8 frames (2, 128, 128,
    3), JAX's raw outputs per level, JAX's detections (dets, valid), the
    threshold they were taken at), built once per process and model."""
    tm = YoloxModule.from_config(YoloxConfig.get_named_config(name),
                                 rng_seed=ZOO[name], device="cpu")
    x = np.random.default_rng(ZOO[name] + 100).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    spread_scores(tm, x)
    jm = JModule.from_config(JConfig.get_named_config(name),
                             rng_seed=ZOO[name])
    params = jax.tree.map(jnp.asarray, state_dict_to_jax(tm.state_dict()))

    def run(p, xx, thr):
        # JAX's `serve` body (uint8 cast on device, float stem, fused
        # postprocess) with the raw outputs it decodes
        fpn = jm.backbone(p["backbone"], xx.astype(jnp.float32), EVAL_CTX,
                          "backbone")
        outs, grids, strides = jm.head.forward_raw_levels(
            p["head"], fpn, EVAL_CTX, "head")
        return outs, jpostprocess(outs, grids, strides, 80, thr, 0.65,
                                  False, MAX_DET)

    fn = jax.jit(run)
    outs, _ = fn(params, jnp.asarray(x), jnp.float32(0.5))
    outs = [np.asarray(o, np.float32) for o in outs]
    scores = _scores(outs)
    thr, gap = gap_threshold(scores, *np.quantile(scores, [0.9, 0.97]))
    assert gap > 1e-3, gap
    _, (dets, valid) = fn(params, jnp.asarray(x), jnp.float32(thr))
    return tm, x, outs, (np.asarray(dets), np.asarray(valid)), thr


@pytest.mark.parametrize("name", list(ZOO))
def test_eval_forward_raw_outputs_match_jax(name):
    tm, x, want, _, _ = _pair(name)
    with torch.inference_mode():
        got, _, _ = tm.head.forward_raw_levels(tm.backbone(
            torch.from_numpy(x).float()))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        err = float(np.abs(g - w).max())
        assert err <= RAW_TOL * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("name", list(ZOO))
def test_serve_on_uint8_frames_matches_jax(name):
    tm, x, _, (want, want_valid), thr = _pair(name)
    dets, valid = tm.serve(x, conf_thre=thr, max_det=MAX_DET)
    assert int(valid.sum()) > 8, int(valid.sum())
    assert_dets_match(dets.numpy(), valid.numpy(), want, want_valid)


def _labels(rng, size, counts, m=8):
    """(B, m, 5) rows (cls, cx, cy, w, h) of 80 classes, `counts` real
    rows per image then zero padding."""
    labels = np.zeros((len(counts), m, 5), np.float32)
    for b, n in enumerate(counts):
        for i in range(n):
            w, h = rng.uniform(size / 12, size / 2, 2)
            labels[b, i] = [rng.integers(0, 80),
                            rng.uniform(w / 2, size - w / 2),
                            rng.uniform(h / 2, size - h / 2), w, h]
    return labels


@pytest.mark.parametrize("fused_bwd", [False, True])
@pytest.mark.parametrize("name", ["yolox_tiny", "yolox_m"])
def test_train_step_matches_jax(name, fused_bwd):
    """One float32 `make_train_step` (EMA, use_l1) of the full model in
    both packages from one state (`train_state_from_jax`)."""
    rng = np.random.default_rng(ZOO[name])
    x = rng.uniform(0, 255, (2, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(
        np.float32)
    labels = _labels(rng, TRAIN_SIZE, [3, 1])
    jcfg = JConfig.get_named_config(name)
    jcfg.lane_fold = False  # the JAX package's TPU layout; same math
    jm = JModule.from_config(jcfg, rng_seed=ZOO[name])
    kw = dict(use_l1=True, fused_bwd=fused_bwd)
    state = j_init(jm.params)
    start = jax.tree.map(np.asarray, state)
    state, want_l = j_make(jm, 80, compute_dtype=jnp.float32, **kw)(
        state, jnp.asarray(x), jnp.asarray(labels), jnp.float32(0.01))
    want = jax.tree.map(np.asarray, state)

    module = YoloxModule.from_config(YoloxConfig.get_named_config(name),
                                     device="cpu")
    tstate = init_train_state(module)
    train_state_from_jax(start, tstate)
    tstate, got_l = make_train_step(module, 80, **kw)(tstate, x, labels,
                                                      0.01)
    got = train_state_to_jax(tstate)
    assert set(got_l) == set(want_l)
    for k in want_l:
        np.testing.assert_allclose(float(got_l[k]), float(want_l[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(got_l["num_fg"]) > 0
    p0 = nested_to_flat(start["params"])
    for part in ("params", "momentum", "ema", "stats"):
        w, g = nested_to_flat(want[part]), nested_to_flat(got[part])
        assert set(g) == set(w), part
        if part == "params":  # the updates, not the parameters
            w = {k: w[k] - p0[k] for k in w}
            g = {k: g[k] - p0[k] for k in g}
        if part == "stats":
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                           err_msg=k)
            continue
        scale = max(float(np.abs(v).max()) for v in w.values())
        for k in w:
            assert float(np.abs(g[k] - w[k]).max()) <= 1e-3 * scale, \
                (part, k)


def test_int8_hbm_serve_of_yolox_l_matches_jax():
    """yolox-l's int8-in-HBM serve (float32 module) with JAX's abs-max
    table: raw outputs and detections at `tests/test_torch_quant.py`'s
    tolerances."""
    name = "yolox_l"
    tm, x, _, _, _ = _pair(name)
    jm = JModule.from_config(JConfig.get_named_config(name),
                             rng_seed=ZOO[name])
    params = jax.tree.map(jnp.asarray, state_dict_to_jax(tm.state_dict()))
    jtable = jm.calibrate_int8(params, jnp.asarray(x, jnp.float32))
    run = _jax_serve(jm, params, jtable, jnp.float32, modes=("hbm",))
    outs, _, _ = run(x, [0.5])["hbm"]
    scores = _scores(outs)
    thr, gap = gap_threshold(scores, *np.quantile(scores, [0.8, 0.95]))
    assert gap > 1e-3, gap
    outs, dets, valid = run(x, [thr])["hbm"]
    table = qtab_from_jax(jtable)
    got_raw = _port_raw(tm, x, "hbm", table)
    for g, w in zip(got_raw, outs):
        d = np.abs(g - w)
        rms = float(np.sqrt((d ** 2).mean()) / (w.std() + 1e-9))
        assert rms < HBM_RMS_TOL and d.max() < 3e-2, (rms, d.max())
    got, got_valid = tm.serve(x, conf_thre=thr, max_det=MAX_DET,
                              int8_hbm_qtab=table)
    # 672 anchors leave no score gap as wide as the int8 score tolerance
    # (measured 1.3e-2), so rows within it of the threshold may go
    # unpaired, as phase 11 of `chip_smoke.py` allows
    flips = unpaired = 0
    for g, gv, w, wv in zip(got.numpy(), got_valid.numpy(), dets, valid):
        f, u, _, _ = match_rows_free_labels(g[gv], w[wv], thr)
        flips, unpaired = flips + f, unpaired + u
    paired = int(valid.sum()) - unpaired
    assert paired >= 3 * INT8_MIN_DETS, (paired, unpaired)
    assert flips <= INT8_LABEL_FLIPS * paired, flips


# ------------------------------------------ phase 18 rehearsed on the CPU

class _Event:
    """`torch.cuda.Event` on the host's clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def _counting(real):
    """A kernel wrapper's stand-in that counts its calls as launches (the
    wrappers count none on the CPU, where they run the plain versions)."""
    def run(*args, **kwargs):
        run.launches += 1
        return real(*args, **kwargs)
    run.launches = 0
    return run


def _rehearsal(monkeypatch):
    """chip_smoke's phase 18 on the CPU: `CARD` "cpu", the card's clocks,
    memory statistics and profiler stubbed, counting wrappers at every
    binding site of the seven kernels, one call of each size."""
    import chip_smoke as cs
    from yolox_tpu_torch.models import blocks
    from yolox_tpu_torch.ops import (
        conv_bwd,
        int8_conv,
        nms,
        nms_kernel,
        quant,
        shear_kernel,
        stem,
        warp,
    )

    monkeypatch.setattr(cs, "CARD", "cpu")
    for name, value in (("synchronize", lambda *a, **k: None),
                        ("Event", _Event), ("_sleep", lambda n: None),
                        ("reset_peak_memory_stats", lambda *a, **k: None),
                        ("max_memory_allocated", lambda *a, **k: 0),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(cs, "device_time",
                        lambda fn, reps=2: (fn(), (0.0, []))[1])
    for sites, name in (((stem, blocks), "stem_conv_bn_act"),
                        ((nms_kernel, nms), "nms_keep"),
                        ((int8_conv, quant), "int8_conv"),
                        ((int8_conv, quant), "int8_dwconv"),
                        ((conv_bwd,), "reduce_sums"),
                        ((conv_bwd,), "main_1x1"),
                        ((shear_kernel, warp), "shear_xy"),
                        ((shear_kernel, warp), "shear_x")):
        wrapper = _counting(getattr(sites[0], name))
        for module in sites:
            monkeypatch.setattr(module, name, wrapper)
    for name, value in (("ZOO_CHECK_B", (1,)), ("ZOO_INT8_B", 1),
                        ("ZOO_PARITY_B", 1), ("ZOO_KERNEL_B", 1),
                        ("ZOO_AUG_B", 1), ("ZOO_STEPS", 1),
                        ("ZOO_LATENCY_REPS", 1), ("ZOO_BATCH_REPS", 1)):
        monkeypatch.setattr(cs, name, value)
    # at 64 px and B 1 the deepest train-mode BN normalizes one image's
    # 2x2 map and float32 rounding swamps the fused-against-autograd
    # comparison (yolox-l: losses 1.78 and 0.36 of their tolerance from
    # the float64 step, gradients 111 and 95), so the rehearsal runs that
    # check's code and not its bound; the bound holds on the card at the
    # models' sizes (0.84-1.07 fused over autograd, PERF.md)
    monkeypatch.setattr(cs, "ZOO_F32_SLACK", float("inf"))
    return cs


@pytest.mark.parametrize("name", list(ZOO))
def test_phase18_rehearsed_on_the_cpu(name, monkeypatch):
    """`run_zoo` on one model at full width, B 1, 64 px: its checks hold
    (the CPU stands for the card), every kernel of its main paths counts
    the launches the phase requires, and its JSON line is whole."""
    import json

    cs = _rehearsal(monkeypatch)
    spec = next(m for m in cs.ZOO_MODELS if m[0] == name)
    lines = []
    launches = cs.run_zoo(lines, models=[(name, spec[1], 64, 1, 1)])
    (line,) = lines
    zoo = json.loads(json.dumps(line))["zoo"]
    train = zoo["train"]
    n = train["kernel_convs"]
    aug = 1 if name == "yolox_tiny" else 0
    # two serve calls, the int8 call, 1 + ZOO_STEPS steps, tiny's augmented
    assert launches["stem"] == launches["nms"] == 3
    assert launches["int8_conv"] == zoo["int8_hbm"]["q1_launches"] > 0
    assert launches["reduce_sums"] == launches["main_1x1"] == n * (2 + aug)
    assert launches["shear_xy"] == aug and launches["int8_dwconv"] == 0
    assert (train["ran_batch"], train["oom_at"]) == (1, [])
    assert zoo["stem"]["channels"] == {"yolox_tiny": 24, "yolox_m": 48,
                                       "yolox_l": 64, "yolox_x": 80}[name]
    assert set(zoo["serve_times"]) == {"float32_b1", "bfloat16_b1"}
    assert (zoo["augment"] is not None) == bool(aug)
