"""The port's training slice against the JAX package's, on the CPU.

- SimOTA and the losses on identical head outputs (numpy): fg_mask,
  matched_gt and num_fg exact; matched_iou and every loss term at rtol
  1e-6 (float32 sums in another order).
- One `make_train_step` of a small CspDarknet YOLOX (depth 0.33, width
  0.25, 8 classes, 128 px, B 2), both steps started from one state, with
  `fused_bwd` off and on, EMA, use_l1 and a frozen prefix; losses, the
  updates of every parameter, the SGD momentum buffers, BN running
  statistics and `num_batches_tracked`, and the EMA compared.
  - float64 (jax x64 / torch double): the losses run in float32 in both
    packages (head outputs are promoted to f32), so the losses agree at
    rtol 1e-6 and every other tensor within 1e-6 of its own largest entry
    plus 1e-9 of the largest entry of its kind across the model (a few
    gradients are zero in exact arithmetic, e.g. of a BN bias that feeds
    another train-mode BN, and carry rounding only).
  - float32: at random init, 1-ulp differences of the two frameworks' conv
    sums grow ~1e3x through the train-mode BN layers (the JAX package
    measures the same between its own fused and unfused paths,
    `tests/test_fused_conv_bwd.py::test_whole_model_fused_grads_match`),
    so rtol 1e-4 / atol 1e-5 holds for the BN statistics only: the losses
    agree at rtol 1e-4, and updates, momentum and EMA within 1e-3 of the
    largest entry of their kind.
- SGD, the five LR schedules and EMA alone; a bf16 step that learns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu import YoloxModule as JModule
from yolox_tpu.core import init_train_state as j_init
from yolox_tpu.core import make_train_step as j_make
from yolox_tpu.models import assign as jassign
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.core import init_train_state, make_train_step
from yolox_tpu_torch.models import assign as tassign
from yolox_tpu_torch.models.weights import (
    nested_to_flat,
    train_state_from_jax,
    train_state_to_jax,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

NUM_CLASSES = 8


def _configs():
    out = []
    for cls in (JConfig, YoloxConfig):
        cfg = cls.get_named_config("yolox_s")
        cfg.depth, cfg.width, cfg.num_classes = 0.33, 0.25, NUM_CLASSES
        cfg.lane_fold = False  # the JAX package's TPU layout; same math
        out.append(cfg)
    return out


def _anchor_grid(size):
    xs, ys, st = [], [], []
    for s in (8, 16, 32):
        h = size // s
        yv, xv = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
        xs.append(xv.ravel())
        ys.append(yv.ravel())
        st.append(np.full(h * h, s))
    return [np.concatenate(v).astype(np.float32) for v in (xs, ys, st)]


def _labels(rng, size, counts, m=8):
    """(B, m, 5) labels, `counts` real rows per image then zero padding."""
    labels = np.zeros((len(counts), m, 5), np.float32)
    for b, n in enumerate(counts):
        for i in range(n):
            w, h = rng.uniform(size / 12, size / 2, 2)
            labels[b, i] = [rng.integers(0, NUM_CLASSES),
                            rng.uniform(w / 2, size - w / 2),
                            rng.uniform(h / 2, size - h / 2), w, h]
    return labels


def _head_outputs(seed, size=256, b=3):
    """Random head outputs near the anchors, as forward_train lays them
    out, and labels with a padded row per image and one image without
    gt."""
    rng = np.random.default_rng(seed)
    xs, ys, st = _anchor_grid(size)
    a = len(xs)
    reg = rng.normal(0, 0.5, (b, a, 4)).astype(np.float32)
    xy = (reg[..., :2] + np.stack([xs, ys], -1)) * st[:, None]
    wh = np.exp(reg[..., 2:]) * st[:, None]
    logits = rng.normal(-2, 1, (b, a, 1 + NUM_CLASSES))
    outputs = np.concatenate([xy, wh, logits], -1).astype(np.float32)
    head = {"outputs": outputs, "origin_reg": reg, "x_shifts": xs,
            "y_shifts": ys, "expanded_strides": st}
    return head, _labels(rng, size, [5, 1, 0][:b])


@pytest.mark.parametrize("num_candidates", [None, 512])
@pytest.mark.parametrize("use_l1", [False, True])
def test_assignment_and_losses_match_jax(use_l1, num_candidates):
    head, labels = _head_outputs(1)
    assert head["outputs"].shape[1] > 512  # 512 compacts
    jhead = {k: jnp.asarray(v) for k, v in head.items()}
    want_a = jax.vmap(lambda lab, bp, ol, cl: jassign.simota_assign(
        lab, bp, ol, cl, jhead["x_shifts"], jhead["y_shifts"],
        jhead["expanded_strides"], NUM_CLASSES,
        num_candidates=num_candidates))(
            jnp.asarray(labels), jhead["outputs"][..., :4],
            jhead["outputs"][..., 4], jhead["outputs"][..., 5:])
    thead = {k: torch.from_numpy(v) for k, v in head.items()}
    got_a = tassign.assign_batch(thead, torch.from_numpy(labels), NUM_CLASSES,
                                 num_candidates)
    for k in ("fg_mask", "matched_gt", "num_fg", "num_gt", "num_cand",
              "cand_idx"):
        np.testing.assert_array_equal(got_a[k].numpy(), np.asarray(want_a[k]),
                                      err_msg=k)
    assert got_a["num_fg"][0] > 0 and got_a["num_fg"][2] == 0
    np.testing.assert_allclose(got_a["matched_iou"].numpy(),
                               np.asarray(want_a["matched_iou"]), rtol=1e-6)

    want = jassign.compute_losses(jhead, jnp.asarray(labels), NUM_CLASSES,
                                  use_l1, num_candidates=num_candidates)
    got = tassign.compute_losses(thead, torch.from_numpy(labels),
                                 NUM_CLASSES, use_l1, num_candidates)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    assert (float(got["l1_loss"]) > 0) == use_l1


def test_losses_given_assignment_is_the_losses_seam():
    """compute_losses == losses_given_assignment(assign_batch(...)), and
    the bce gradient is the closed form sigmoid - target."""
    head, labels = _head_outputs(2, size=128)
    thead = {k: torch.from_numpy(v) for k, v in head.items()}
    thead["outputs"].requires_grad_(True)
    lab = torch.from_numpy(labels)
    a = tassign.assign_batch(thead, lab, NUM_CLASSES)
    held = tassign.losses_given_assignment(thead, lab, a, NUM_CLASSES)
    full = tassign.compute_losses(thead, lab, NUM_CLASSES)
    for k in full:
        assert torch.equal(full[k], held[k]), k
    held["conf_loss"].backward()
    obj = thead["outputs"].detach()[..., 4]
    want = (torch.sigmoid(obj) - a["fg_mask"].float()) / a["num_fg"].sum()
    torch.testing.assert_close(thead["outputs"].grad[..., 4], want,
                               rtol=1e-6, atol=1e-9)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    return x, _labels(rng, 128, [3, 1], m=6)


def _jax_step(jmodule, f64, x, labels, kw):
    dt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        params = jax.tree.map(
            lambda a: jnp.asarray(a, dt)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jmodule.params)
        state = j_init(params)
        start = jax.tree.map(np.asarray, state)
        step = j_make(jmodule, NUM_CLASSES, compute_dtype=dt, **kw)
        state, losses = step(state, jnp.asarray(x, dt), jnp.asarray(labels),
                             jnp.asarray(0.01, dt))
        return (start, jax.tree.map(np.asarray, state),
                {k: float(v) for k, v in losses.items()})


@pytest.mark.parametrize("precision,fused_bwd,freeze_prefix", [
    ("float64", False, None),
    ("float64", True, None),
    ("float64", True, "backbone.backbone"),
    ("float32", False, None),
    ("float32", True, None),
])
def test_train_step_matches_jax(precision, fused_bwd, freeze_prefix):
    f64 = precision == "float64"
    jcfg, tcfg = _configs()
    x, labels = _batch()
    kw = dict(use_l1=True, freeze_prefix=freeze_prefix, fused_bwd=fused_bwd)
    start, want, want_l = _jax_step(JModule.from_config(jcfg, rng_seed=0),
                                    f64, x, labels, kw)

    module = YoloxModule.from_config(tcfg, device="cpu")
    if f64:
        module = module.double()
    state = init_train_state(module)
    train_state_from_jax(start, state)
    step = make_train_step(module, NUM_CLASSES, compute_dtype=module.dtype,
                           **kw)
    state, got_l = step(state, x, labels, 0.01)
    got = train_state_to_jax(state)
    assert (got["step"], got["ema_updates"]) == (1, 1)

    assert set(got_l) == set(want_l)
    for k in want_l:
        np.testing.assert_allclose(float(got_l[k]), want_l[k],
                                   rtol=1e-6 if f64 else 1e-4, err_msg=k)
    p0 = nested_to_flat(start["params"])
    for part in ("params", "momentum", "ema", "stats"):
        w, g = nested_to_flat(want[part]), nested_to_flat(got[part])
        assert set(g) == set(w), part
        if part == "params":  # the updates, not the parameters
            w = {k: w[k] - p0[k] for k in w}
            g = {k: g[k] - p0[k] for k in g}
        if part == "stats" and not f64:
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                           err_msg=k)
            continue
        scale = max(float(np.abs(v).max()) for v in w.values())
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            own = float(np.abs(w[k]).max())
            lim = 1e-6 * own + 1e-9 * scale if f64 else 1e-3 * scale
            assert float(np.abs(g[k] - w[k]).max()) <= lim, (part, k)
    frozen = [k for k in nested_to_flat(start["stats"])
              if freeze_prefix and k.startswith(freeze_prefix)]
    for k in frozen:  # eval-mode BN: statistics and counters unchanged
        np.testing.assert_array_equal(nested_to_flat(got["stats"])[k],
                                      nested_to_flat(start["stats"])[k])
    if freeze_prefix:
        for k, v in nested_to_flat(got["params"]).items():
            if k.startswith(freeze_prefix):
                np.testing.assert_array_equal(v, p0[k], err_msg=k)


def test_train_state_round_trip():
    jcfg, tcfg = _configs()
    start = jax.tree.map(np.asarray, j_init(JModule.from_config(
        jcfg, rng_seed=1).params))
    rng = np.random.default_rng(3)
    start["momentum"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype),
        start["momentum"])
    start["step"], start["ema_updates"] = np.int32(7), np.int32(5)
    state = init_train_state(YoloxModule.from_config(tcfg, device="cpu"))
    train_state_from_jax(start, state)
    back = train_state_to_jax(state)
    for part in ("params", "stats", "momentum", "ema"):
        w, g = nested_to_flat(start[part]), nested_to_flat(back[part])
        assert set(w) == set(g), part
        for k in w:
            assert g[k].dtype == w[k].dtype, (part, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert (back["step"], back["ema_updates"]) == (7, 5)


def test_train_mode_never_reaches_the_stem_kernel(monkeypatch):
    """K1 folds running statistics and has no gradient: train mode runs
    Focus as space-to-depth + BaseConv with batch statistics."""
    from yolox_tpu_torch.models import blocks

    def refuse(*a, **k):
        raise AssertionError("the stem kernel ran in train mode")

    _, tcfg = _configs()
    module = YoloxModule.from_config(tcfg, device="cpu").train()
    monkeypatch.setattr(blocks, "stem_conv_bn_act", refuse)
    x, _ = _batch()
    out = module.forward_train(torch.from_numpy(x))
    assert out["outputs"].shape == (2, 336, 5 + NUM_CLASSES)
    assert module.backbone.backbone.stem.conv.bn.num_batches_tracked == 1
    with pytest.raises(RuntimeError, match="eval"):
        module(x)


def test_sgd_matches_jax_sgd_update():
    from yolox_tpu.core.optimizer import init_momentum, sgd_update
    from yolox_tpu_torch.core.optimizer import build_optimizer, set_hyperparams

    rng = np.random.default_rng(0)
    conv = torch.nn.Conv2d(4, 6, 3)
    bn = torch.nn.BatchNorm2d(6)
    module = torch.nn.ModuleDict({"conv": conv, "bn": bn})
    names = [n for n, _ in module.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in
              module.named_parameters()}
    mask = {n: 1.0 if p.ndim == 4 else 0.0 for n, p in params.items()}
    opt = build_optimizer(module, lr=0.0)
    assert [g["name"] for g in opt.param_groups] == ["bn_weights", "decay",
                                                     "biases"]
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    buf = init_momentum(jp)
    for i, lr in enumerate((0.01, 0.02, 0.005)):
        grads = {n: rng.standard_normal(v.shape).astype(np.float32)
                 for n, v in params.items()}
        for n, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        set_hyperparams(opt, lr=lr, momentum=0.9, weight_decay=5e-4)
        opt.step()
        jp, buf = sgd_update(jp, {n: jnp.asarray(g) for n, g in
                                  grads.items()}, buf, mask, lr=lr,
                             momentum=0.9, weight_decay=5e-4)
    for n, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(),
                                   np.asarray(buf[n]), rtol=1e-6, atol=1e-7)
    assert names == ["conv.weight", "conv.bias", "bn.weight", "bn.bias"]


@pytest.mark.parametrize("name", ["cos", "warmcos", "yoloxwarmcos",
                                  "yoloxsemiwarmcos", "multistep"])
def test_lr_schedules_match_jax(name):
    from yolox_tpu.utils.lr_scheduler import LRScheduler as JLR
    from yolox_tpu_torch.utils.lr_scheduler import LRScheduler

    kw = dict(warmup_epochs=5, warmup_lr_start=1e-4, no_aug_epochs=15,
              min_lr_ratio=0.05, milestones=[150, 250], semi_epoch=100,
              iters_per_epoch_semi=70)
    want, got = JLR(name, 0.01, 50, 300, **kw), LRScheduler(name, 0.01, 50,
                                                            300, **kw)
    for it in (0, 1, 120, 249, 250, 251, 5000, 7400, 9000, 14249, 14250,
               14999):
        assert got.update_lr(it) == want.update_lr(it), (name, it)
    cfg = YoloxConfig.get_named_config("yolox_s")
    jcfg = JConfig.get_named_config("yolox_s")
    a, b = cfg.get_lr_scheduler(0.02, 100), jcfg.get_lr_scheduler(0.02, 100)
    assert [a.update_lr(i) for i in (0, 300, 29000)] == [
        b.update_lr(i) for i in (0, 300, 29000)]


def test_ema_matches_formula_and_jax():
    from yolox_tpu.utils.ema import ema_update, init_ema
    from yolox_tpu_torch.utils.ema import ModelEMA

    bn = torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.fill_(2.0)
    ema = ModelEMA(bn)
    with torch.no_grad():
        bn.weight.fill_(4.0)
        bn.running_mean.fill_(1.0)
        bn.num_batches_tracked.fill_(1)
    fresh = ModelEMA(torch.nn.BatchNorm2d(3)).ema.state_dict()
    jema = init_ema({k: jnp.asarray(v.numpy()) for k, v in fresh.items()})
    jema["weight"] = jnp.full((3,), 2.0, jnp.float32)
    for updates in (1, 2):
        ema.update(bn, 0.9998)
        jema = ema_update(jema, {k: jnp.asarray(v.numpy()) for k, v in
                                 bn.state_dict().items()},
                          jnp.int32(updates), 0.9998)
    d1 = 0.9998 * (1 - np.exp(-1 / 2000))
    d2 = 0.9998 * (1 - np.exp(-2 / 2000))
    expect = (2.0 * d1 + 4.0 * (1 - d1)) * d2 + 4.0 * (1 - d2)
    sd = ema.ema.state_dict()
    np.testing.assert_allclose(sd["weight"].numpy(), expect, rtol=1e-6)
    for k, v in sd.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jema[k]), rtol=1e-6,
                                   err_msg=k)
    assert int(sd["num_batches_tracked"]) == 1 and ema.updates == 2


@pytest.mark.smoke
def test_bf16_train_step_runs_and_learns():
    """f32 master weights, bf16 compute: finite losses that fall over a
    few steps on one batch; parameters, momentum and EMA stay f32."""
    _, tcfg = _configs()
    tcfg.depth, tcfg.width = 0.33, 0.125
    module = YoloxModule.from_config(tcfg, device="cpu")
    state = init_train_state(module)
    step = make_train_step(module, NUM_CLASSES, compute_dtype=torch.bfloat16,
                           fused_bwd=True)
    x, labels = _batch()
    losses = []
    for _ in range(12):
        state, m = step(state, x, labels, 0.01)
        losses.append(float(m["total_loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert all(b.dtype == torch.float32
               for b in state.optimizer.state[module.head.stems[0].conv.weight
                                              ].values())
    assert state.ema.ema.head.stems[0].conv.weight.dtype == torch.float32
