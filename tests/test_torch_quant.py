"""The port's int8 PTQ serving (`yolox_tpu_torch/ops/quant.py`, the int8
hooks of the blocks, `YoloxModule.calibrate_int8` / `enable_int8` /
`serve(int8_qtab=..., int8_hbm_qtab=...)`) against the JAX package's
`yolox_tpu/ops/quant.py` on the CPU, where the int8 convs Q1 / Q2 run
their plain versions (exact float64 sums of the codes).

Inputs come from numpy seeds; weights from the JAX package's seeded init
with BatchNorm statistics randomized, moved across with the weight
converters. Tolerances:
- function by function: integer results (codes, int8 weights, sums)
  exactly; float32 results at rtol 1e-6 / atol 1e-6 (1e-5 where BN is
  folded: rsqrt may differ by an ulp between XLA and torch);
- calibration tables: the same keys; float32 entries within 1e-4 of each
  entry's largest value (the float forward's ~1e-6 differences, grown
  through the layers), bf16 modules within 2^-5 of it (measured 2^-5.6:
  XLA computes some of the bf16 float path's ops fused in float32 where
  torch rounds each to bf16, so activations drift by a few bf16 ulps);
- raw head outputs of both modes at rms 1.2e-2 of the output's spread and
  max 3e-2 absolute (measured up to 9e-3 / 2.3e-2, on yolov3's bf16
  ladder). The HBM mode's prediction convs run in bf16 for every module,
  so its outputs, and a bf16 module's, differ by single bf16 roundings
  (2^-8, ~0.004 at the outputs' scale); and a code flips where XLA's
  fused multiply-adds and the port's separate roundings land on either
  side of a rounding boundary, a flip that propagates through yolov3's
  ~50 quantized layers. JAX's own allowance between int8 and float is rms
  0.15 (ladder) / 0.02 (HBM);
- serve detections at `assert_dets_match`'s rtol 1e-3 / atol 5e-2 for the
  float32 ladder; where bf16 outputs decode (the HBM mode, bf16 modules)
  `chip_smoke.match_rows_free_labels` (boxes within 0.5 px, scores within
  0.03, a label free to differ on at most a tenth of the rows: bf16 class
  confidences tie exactly, and one bf16 rounding elsewhere moves the
  argmax); the threshold in a gap of JAX's own int8 scores.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    INT8_LABEL_FLIPS,
    assert_dets_match,
    gap_threshold,
    match_rows_free_labels,
    spread_scores,
)
from test_torch_blocks import _nchw, _nhwc, _randomize_bn
from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu import YoloxModule as JModule
from yolox_tpu.models.blocks import EVAL_CTX
from yolox_tpu.models.head import YoloxHead as JYoloxHead
from yolox_tpu.models.yolo_fpn import YoloFpn as JYoloFpn
from yolox_tpu.ops import quant as jq
from yolox_tpu.ops.nms import postprocess_fused_levels as jpostprocess
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.models.blocks import BaseConv, Focus
from yolox_tpu_torch.models.head import YoloxHead
from yolox_tpu_torch.models.weights import (
    qtab_from_jax,
    state_dict_from_jax,
    state_dict_to_jax,
)
from yolox_tpu_torch.models.yolo_fpn import YoloFpn
from yolox_tpu_torch.ops import quant as tq
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

SIZE = 64           # image side of the model-level tests
F32_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


def _bn(rng, c):
    return {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32),
            "running_mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
            "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


def _conv_params(rng, k, cin, cout, groups=1):
    w = rng.uniform(-0.3, 0.3, (k, k, cin // groups, cout)).astype(np.float32)
    return {"conv": {"weight": w}, "bn": _bn(rng, cout)}


def _port_params(p):
    return {"conv": {"weight": _oihw(p["conv"]["weight"])},
            "bn": {k: _t(v) for k, v in p["bn"].items()}}


# ------------------------------------------------------- function by function

def test_act_scale_and_quantize_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-3, 3, (4, 8, 8, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -1.5, 2.5, 0.0]  # exact halves of some scales
    for amax in (float(np.abs(x).max()), 1.0, 0.0, 127.0 * 0.5):
        want_s = jq.act_scale(amax)
        got_s = tq.act_scale(amax)
        assert got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        want = np.asarray(jq.quantize(jnp.asarray(x), want_s))
        got = tq.quantize(_t(x), got_s)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    # bf16 activations quantize from their float32 value
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        tq.quantize(_t(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                    tq.act_scale(2.0)).numpy(),
        np.asarray(jq.quantize(xb, jq.act_scale(2.0))))


@pytest.mark.parametrize("groups", [1, 8])
def test_fold_bn_weight_qparams_fold_in_scale_match_jax(groups):
    rng = np.random.default_rng(1)
    p = _conv_params(rng, 3, 8, 8, groups)
    wf_j, b_j = jq.fold_bn(jnp.asarray(p["conv"]["weight"]),
                           jax.tree.map(jnp.asarray, p["bn"]))
    tp = _port_params(p)
    wf_t, b_t = tq.fold_bn(tp["conv"]["weight"], tp["bn"])
    np.testing.assert_allclose(wf_t.numpy(), _oihw(wf_j).numpy(), rtol=1e-5,
                               atol=F32_TOL)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-5,
                               atol=F32_TOL)
    # from the same fused weights, integer weights and scales exactly
    wq_j, sw_j = jq.weight_qparams(wf_j)
    wq_t, sw_t = tq.weight_qparams(_oihw(wf_j))
    np.testing.assert_array_equal(wq_t.numpy(), _oihw(wq_j).numpy())
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))
    scale = rng.uniform(0.01, 0.1, 8).astype(np.float32)
    np.testing.assert_array_equal(
        tq.fold_in_scale(_oihw(wf_j), _t(scale), groups).numpy(),
        _oihw(jq.fold_in_scale(wf_j, jnp.asarray(scale), groups)).numpy())
    with pytest.raises(NotImplementedError):
        tq.fold_in_scale(torch.zeros(8, 2, 3, 3), _t(scale), 4)


@pytest.mark.parametrize("act", ["silu", "lrelu"])
@pytest.mark.parametrize("k,stride,groups", [(3, 1, 1), (3, 2, 1), (1, 1, 1),
                                             (3, 1, 8), (3, 2, 8)])
def test_conv_bn_act_matches_integer_oracle_and_jax(k, stride, groups, act):
    """The ladder conv sums exactly: the port equals the float oracle of
    `tests/test_quant.py` (the codes convolved in float, values < 2^24)
    and JAX's `conv_bn_act`; the HBM conv likewise."""
    rng = np.random.default_rng(2)
    p = _conv_params(rng, k, 8, 8, groups)
    x = rng.uniform(-2, 2, (2, 7, 9, 8)).astype(np.float32)
    amax = float(np.abs(x).max())
    tp = _port_params(p)
    got = tq.conv_bn_act(_nchw(x), tp, amax, stride, groups, act)
    jact = {"silu": jax.nn.silu, "lrelu": lambda v: jnp.where(v >= 0, v,
                                                               0.1 * v)}[act]
    want = jq.conv_bn_act(jnp.asarray(x), jax.tree.map(jnp.asarray, p), amax,
                          stride, groups, jact)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the integer oracle, on the port's own quantities
    w_fused, bias = tq.fold_bn(tp["conv"]["weight"], tp["bn"])
    wq, sw = tq.weight_qparams(w_fused)
    sx = tq.act_scale(amax)
    xq = tq.quantize(_nchw(x), sx)
    acc = torch.nn.functional.conv2d(xq.float(), wq.float(), stride=stride,
                                     padding=(k - 1) // 2, groups=groups)
    ref = acc * (sx * sw).view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    from yolox_tpu_torch.ops.stem import activate

    torch.testing.assert_close(got, activate(ref, act), rtol=F32_TOL,
                               atol=F32_TOL)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # HBM: codes + per-channel scale in, requantized codes out
    codes = rng.integers(-127, 128, (2, 7, 9, 8)).astype(np.int8)
    scale = rng.uniform(0.01, 0.05, 8).astype(np.float32)
    out_amax = rng.uniform(1, 3, 8).astype(np.float32)
    jqt = jq.QTensor(jnp.asarray(codes), jnp.asarray(scale))
    tqt = tq.QTensor(_nchw(codes), _t(scale))
    for requant_out in (True, False):
        want = jq.conv_bn_act_hbm(jqt, jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(out_amax), stride, groups,
                                  jact, requant_out)
        got = tq.conv_bn_act_hbm(tqt, tp, _t(out_amax), stride, groups, act,
                                 requant_out)
        if requant_out:
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale))
            d = np.abs(_nhwc(got.codes).astype(int)
                       - np.asarray(want.codes).astype(int))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-2, d.max()
        else:
            np.testing.assert_allclose(_nhwc(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_q_ops_match_jax():
    rng = np.random.default_rng(3)
    ca = rng.integers(-127, 128, (2, 5, 7, 6)).astype(np.int8)
    cb = rng.integers(-127, 128, (2, 5, 7, 4)).astype(np.int8)
    sa = rng.uniform(0.01, 0.1, 6).astype(np.float32)
    sb = rng.uniform(0.01, 0.1, 4).astype(np.float32)
    ja, jb_ = jq.QTensor(jnp.asarray(ca), jnp.asarray(sa)), jq.QTensor(
        jnp.asarray(cb), jnp.asarray(sb))
    ta, tb_ = tq.QTensor(_nchw(ca), _t(sa)), tq.QTensor(_nchw(cb), _t(sb))
    np.testing.assert_array_equal(_nhwc(tq.dequant(ta)),
                                  np.asarray(jq.dequant(ja)))
    cat_t, cat_j = tq.q_concat([ta, tb_]), jq.q_concat([ja, jb_])
    np.testing.assert_array_equal(_nhwc(cat_t.codes), np.asarray(cat_j.codes))
    np.testing.assert_array_equal(cat_t.scale.numpy(), np.asarray(cat_j.scale))
    up_t, up_j = tq.q_upsample_nearest_2x(ta), jq.q_upsample_nearest_2x(ja)
    np.testing.assert_array_equal(_nhwc(up_t.codes), np.asarray(up_j.codes))
    assert up_t.codes.is_contiguous(memory_format=torch.channels_last)
    for k in (5, 9, 13):
        pt, pj = tq.q_max_pool_same(ta, k), jq.q_max_pool_same(ja, k)
        np.testing.assert_array_equal(_nhwc(pt.codes), np.asarray(pj.codes))
    amax = rng.uniform(1, 5, 6).astype(np.float32)
    add_t = tq.q_add(ta, tq.QTensor(_nchw(ca[..., ::-1].copy()), _t(sa)),
                     _t(amax))
    add_j = jq.q_add(ja, jq.QTensor(jnp.asarray(ca[..., ::-1].copy()),
                                    jnp.asarray(sa)), jnp.asarray(amax))
    np.testing.assert_array_equal(_nhwc(add_t.codes), np.asarray(add_j.codes))
    y = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    rq_t, rq_j = tq.requant(_nchw(y), _t(amax)), jq.requant(jnp.asarray(y),
                                                            jnp.asarray(amax))
    np.testing.assert_array_equal(_nhwc(rq_t.codes), np.asarray(rq_j.codes))
    np.testing.assert_array_equal(rq_t.scale.numpy(), np.asarray(rq_j.scale))
    # the bf16 prediction conv on the codes, at bf16 tolerance
    w = rng.uniform(-0.1, 0.1, (1, 1, 6, 5)).astype(np.float32)
    b = rng.uniform(-1, 1, 5).astype(np.float32)
    got = tq.pred_conv_hbm(ta, _oihw(w), _t(b))
    want = jq.pred_conv_hbm(ja, jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got.float()),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-2)
    tables = [{"a": _t(sa), "b": torch.tensor(2.0)},
              {"a": _t(sa[::-1].copy()), "b": torch.tensor(1.0)}]
    merged = tq.merge_amax(tq.merge_amax({}, tables[0]), tables[1])
    np.testing.assert_array_equal(merged["a"].numpy(),
                                  np.maximum(sa, sa[::-1]))
    assert float(merged["b"]) == 2.0


@pytest.mark.parametrize("n", [1, 2, 999, 4096])
def test_percentile_matches_jnp(n):
    """`jnp.percentile` as `calibrate_int8` runs it: inside a jit with the
    percentile a constant (XLA then folds q / 100; called eagerly it may
    round the position by an ulp otherwise)."""
    rng = np.random.default_rng(n)
    a = np.abs(rng.normal(size=(3, 2, n, 1))).astype(np.float32)
    for q in (99.9, 50.0, 99.99):
        np.testing.assert_array_equal(
            tq.percentile(_t(a), q).numpy(),
            np.asarray(jax.jit(lambda v: jnp.percentile(v, q))(a)))
        np.testing.assert_array_equal(
            tq.percentile(_t(a), q, channels=True).numpy(),
            np.asarray(jax.jit(lambda v: jnp.percentile(
                v, q, axis=(0, 1, 2)))(a.transpose(0, 2, 3, 1))))


# --------------------------------------------------------------- the models

def _jax_model(name):
    if name == "yolov3":
        return JModule(JYoloFpn(depth=21), JYoloxHead(
            80, 1.0, in_channels=(128, 256, 512), act="lrelu"))
    cfg = JConfig.get_named_config(name)
    cfg.width = 0.125 if name == "yolox_s" else cfg.width
    return JModule.from_config(cfg, rng_seed=11)


def _port_model(name):
    if name == "yolov3":
        return YoloxModule(YoloFpn(depth=21), YoloxHead(
            80, 1.0, in_channels=(128, 256, 512), act="lrelu"))
    cfg = YoloxConfig.get_named_config(name)
    cfg.width = 0.125 if name == "yolox_s" else cfg.width
    return YoloxModule.from_config(cfg, device="cpu")


MODELS = ["yolox_nano", "yolox_s", "yolov3"]


@functools.lru_cache(maxsize=None)
def _models(name):
    """(name, JAX module, its params, the port module with the same
    weights, uint8 frames, JAX's abs-max table of the float32 model),
    built once per process and model."""
    jm, tm = _jax_model(name), _port_model(name)
    rng = np.random.default_rng(12)
    tm.load_params(state_dict_from_jax(_randomize_bn(jm.init(12), rng)))
    x = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    spread_scores(tm, x)  # decisive scores, so detections can be compared
    params = jax.tree.map(jnp.asarray, state_dict_to_jax(tm.state_dict()))
    table = jm.calibrate_int8(params, jnp.asarray(x, jnp.float32))
    return name, jm, params, tm, x, table


def _close_table(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), k


@pytest.mark.parametrize("name", MODELS)
def test_calibration_table_equals_jax(name):
    """Keys and values, abs-max; the keys are the port's module names
    with JAX's suffixes; NCHW input and a two-batch merge."""
    _, jm, params, tm, x, want = _models(name)
    _close_table(tm.calibrate_int8(x), want, 1e-4)
    names = dict(tm.named_modules())
    for key in want:
        base = key
        for suffix in (".addout", ".out"):
            base = base[:-len(suffix)] if base.endswith(suffix) else base
        mod = names.get(base)
        if isinstance(mod, BaseConv) and isinstance(
                names.get(base.rsplit(".", 1)[0]), Focus):
            continue  # `<stem>.conv` / `.conv.out`: the Focus stem's keys
        assert isinstance(mod, (BaseConv,)) or key.endswith(".addout"), key
    convs = {n for n, m in names.items() if isinstance(m, BaseConv)}
    stem = {f"{n}.conv" for n, m in names.items() if isinstance(m, Focus)}
    assert {k for k in want if not k.endswith((".out", ".addout"))} == convs
    assert stem <= convs
    if name != "yolox_s":  # NCHW input and a two-batch merge: once
        return
    x2 = np.minimum(x.astype(np.int32) * 2, 255).astype(np.uint8)
    want2 = jm.calibrate_int8(params, [jnp.asarray(x, jnp.float32),
                                       jnp.asarray(x2, jnp.float32)])
    _close_table(tm.calibrate_int8([x.transpose(0, 3, 1, 2), _t(x2)]), want2,
                 1e-4)


def test_percentile_calibration_and_bf16_tables_equal_jax():
    name, jm, params, tm, x, _ = _models("yolox_s")
    want = jm.calibrate_int8(params, jnp.asarray(x, jnp.float32),
                             percentile=99.9)
    _close_table(tm.calibrate_int8(x, percentile=99.9), want, 1e-4)
    jm16 = _jax_model(name)
    jm16.dtype = jnp.bfloat16
    want16 = jm16.calibrate_int8(JModule.cast_params(params, jnp.bfloat16),
                                 jnp.asarray(x, jnp.float32))
    tm16 = _port_model(name)
    tm16.load_params(tm.state_dict())
    _close_table(tm16.cast_params(torch.bfloat16).calibrate_int8(x), want16,
                 2 ** -5)


def _jax_serve(jm, params, table, dtype, modes=("ladder", "hbm"),
               stem_s2d=False):
    """A jitted fn(x, thrs) -> for each of `modes`, JAX's raw head outputs
    and serve detections (max_det 64, threshold thrs[i], traced as
    `serve_jit` passes it) for a `dtype` module, as `YoloxModule.serve`
    computes them; the modes share one compile."""
    p = JModule.cast_params(params, dtype)

    def run(p, xx, thrs):
        xx = xx.astype(dtype)
        # stem_s2d: JAX's default at B <= 32, the space-to-depth stem
        base = dataclasses.replace(EVAL_CTX, stem_s2d=stem_s2d)
        res = []
        for mode, thr in zip(modes, thrs):
            ctx = dataclasses.replace(base, **{
                "int8_qtab" if mode == "ladder" else "int8_hbm_qtab": table})
            fpn = jm.backbone(p["backbone"], xx, ctx, "backbone")
            outs, grids, strides = jm.head.forward_raw_levels(
                p["head"], fpn, ctx, "head")
            res.append((outs, jpostprocess(outs, grids, strides, 80, thr,
                                           0.65, False, 64)))
        return res

    fn = jax.jit(run)

    def call(x, thrs):
        res = fn(p, jnp.asarray(x), jnp.asarray(thrs, jnp.float32))
        return {mode: ([np.asarray(o, np.float32) for o in outs],
                       np.asarray(dets), np.asarray(valid))
                for mode, (outs, (dets, valid)) in zip(modes, res)}

    return call


@functools.lru_cache(maxsize=None)
def _jax_int8(name, dtype):
    """JAX's outputs of both int8 modes for model `name` as a `dtype`
    module, each mode's detections at a threshold in a gap of its own
    scores: {mode: (raw outputs, dets, valid, threshold)}."""
    _, jm, params, _, x, table = _models(name)
    run = _jax_serve(jm, params, table, getattr(jnp, dtype))
    thrs = []
    for outs, _, _ in run(x, [0.5, 0.5]).values():
        scores = _scores(outs)
        thr, gap = gap_threshold(scores, *np.quantile(scores, [0.9, 0.99]))
        assert gap > 2e-2, gap
        thrs.append(thr)
    return {mode: r + (thr,) for (mode, r), thr in zip(run(x, thrs).items(),
                                                       thrs)}


def _port_raw(tm, x, mode, table):
    with tm._int8_mode(mode, table), torch.inference_mode():
        outs, _, _ = tm.head.forward_raw_levels(
            tm.backbone(tm._image_batch(x, mode)))
    return [o.float().numpy() for o in outs]


def _check_outputs(got, want, max_abs=3e-2):
    for g, w in zip(got, want):
        d = np.abs(g - w)
        rms = float(np.sqrt((d ** 2).mean()) / (w.std() + 1e-9))
        assert rms < 1.2e-2 and d.max() < max_abs, (rms, d.max())


def _scores(outs):
    o = np.concatenate(outs, 1)
    return o[..., 4] * o[..., 5:].max(-1)


@pytest.mark.parametrize("mode", ["ladder", "hbm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_int8_outputs_and_serve_match_jax(name, mode, dtype):
    """Raw head outputs and `serve` detections of both int8 modes, with
    JAX's table through `qtab_from_jax`, float32 and bf16 modules; the
    yolox-s ladder also against JAX's default space-to-depth stem."""
    _, jm, params, tm, x, jtable = _models(name)
    table = qtab_from_jax(jtable)
    if dtype == "bfloat16":
        tm16 = _port_model(name)
        tm16.load_params(tm.state_dict())
        tm = tm16.cast_params(torch.bfloat16)
    outs, dets, valid, thr = _jax_int8(name, dtype)[mode]
    _check_outputs(_port_raw(tm, x, mode, table), outs)
    kw = {"int8_qtab" if mode == "ladder" else "int8_hbm_qtab": table}
    got, got_valid = tm.serve(x, conf_thre=thr, max_det=64, **kw)
    assert valid.sum() >= 4
    if mode == "ladder" and dtype == "float32":
        assert_dets_match(got.numpy(), got_valid.numpy(), dets, valid,
                          rtol=1e-3, atol=5e-2)
    else:  # bf16 outputs decode: class confidences may tie exactly
        np.testing.assert_array_equal(got_valid.numpy(), valid)
        flips = sum(match_rows_free_labels(g[v], w[v])[0] for g, v, w in
                    zip(got.numpy(), valid, dets))
        assert flips <= INT8_LABEL_FLIPS * valid.sum(), flips
    if name == "yolox_s" and dtype == "float32" and mode == "ladder":
        _, dets_s2d, valid_s2d = _jax_serve(
            jm, params, jtable, jnp.float32, ("ladder",),
            stem_s2d=True)(x, [thr])["ladder"]
        assert_dets_match(got.numpy(), got_valid.numpy(), dets_s2d,
                          valid_s2d, rtol=1e-3, atol=5e-2)


def test_enable_int8_then_call_and_load_params():
    """After `enable_int8`, `__call__` runs int8 (JAX's `enable_int8`
    then `__call__`); `load_params` afterwards takes effect (the cached
    int8 weights are rebuilt), and so does `cast_params`."""
    name, _, params, tm, x, jtable = _models("yolox_s")
    table = qtab_from_jax(jtable)
    jm = _jax_model(name)
    jm.params = params
    jm.enable_int8(jtable)
    fresh = _port_model(name)
    fresh.load_params(tm.state_dict())
    fresh.enable_int8(table)
    got = fresh(x).numpy()
    want = np.asarray(jm(jnp.asarray(x, jnp.float32)))
    _check_outputs([got], [want], max_abs=0.1)  # decoded: boxes in pixels
    # new weights: the BN statistics moved
    rng = np.random.default_rng(13)
    new = _randomize_bn(state_dict_to_jax(tm.state_dict()), rng)
    fresh.load_params(state_dict_from_jax(new))
    want_new = np.asarray(jm(jnp.asarray(x, jnp.float32),
                             params=jax.tree.map(jnp.asarray, new)))
    got_new = fresh(x).numpy()
    assert np.abs(got_new - got).max() > 1e-2
    _check_outputs([got_new], [want_new], max_abs=0.1)
    # the HBM mode and a bf16 cast after enable_int8
    fresh.enable_int8(table, hbm=True)
    hbm = fresh(x)
    fresh.cast_params(torch.bfloat16)
    ref16 = _port_model(name)
    ref16.load_params(state_dict_from_jax(new))
    ref16.cast_params(torch.bfloat16)
    ref16.enable_int8(table, hbm=True)
    torch.testing.assert_close(fresh(x), ref16(x), rtol=0, atol=0)
    assert not torch.equal(fresh(x), hbm)


def test_int8_in_train_mode_raises():
    name, _, _, tm, x, jtable = _models("yolox_nano")
    table = qtab_from_jax(jtable)
    m = _port_model(name)
    m.load_params(tm.state_dict())
    m.train()
    for mode in ("ladder", "hbm", "calib"):
        with m._int8_mode(mode, table), \
                pytest.raises(RuntimeError, match="serving/eval-only"):
            m.forward_train(torch.zeros(1, SIZE, SIZE, 3))
    with pytest.raises(RuntimeError):
        m.calibrate_int8(x)
    with pytest.raises(RuntimeError):
        m.serve(x, int8_qtab=table)


@pytest.mark.parametrize("name", ["yolox_nano", "yolox_s"])
def test_ladder_stem_runs_q1_not_k1_and_dwconv_runs_q2(name, monkeypatch):
    """Which kernel each block calls in each mode (counted at the
    wrappers): the ladder runs Q1 for every dense BaseConv, the Focus
    stem's folded conv included, and no K1; the HBM mode runs K1 once and
    Q1 for every dense BaseConv but the stem; depthwise convs run Q2."""
    _, _, _, tm, x, jtable = _models(name)
    from yolox_tpu_torch.models import blocks as tb

    calls = {"q1": 0, "q2": 0, "k1": 0}

    def counted(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tq, "int8_conv", counted("q1", tq.int8_conv))
    monkeypatch.setattr(tq, "int8_dwconv", counted("q2", tq.int8_dwconv))
    monkeypatch.setattr(tb, "stem_conv_bn_act",
                        counted("k1", tb.stem_conv_bn_act))
    convs = [m for m in tm.modules() if isinstance(m, BaseConv)]
    dense = sum(m.conv.groups == 1 for m in convs) - 1  # Focus's inner conv
    dw = sum(m.conv.groups > 1 for m in convs)
    table = qtab_from_jax(jtable)
    tm.serve(x, int8_qtab=table)
    assert calls == {"q1": dense + 1, "q2": dw, "k1": 0}, calls
    calls.update(q1=0, q2=0, k1=0)
    tm.serve(x, int8_hbm_qtab=table)
    assert calls == {"q1": dense, "q2": dw, "k1": 1}, calls
    assert (dw > 0) == (name == "yolox_nano")
