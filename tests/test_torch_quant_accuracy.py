"""`scripts/torch_quant_accuracy.py` (the port's int8 accuracy harness)
against the JAX package's `scripts/quant_accuracy.py` on the CPU.

- `agreement` equals JAX's on seeded detection lists, empty images and
  empty lists included;
- `train_overfit` draws the same images and gt boxes, bit for bit (the
  JAX side with its train step stubbed out: only its draws are compared);
- `run` gives JAX's table for the same weights: a seeded nano whose
  prediction convs are amplified, so that on the harness's noise images
  it makes a few detections (5 at the threshold below) with no training
  (objectness weights N(0, 3e5), bias -4; class weights zero, so the
  class is constant; regression weights N(0, 1e4)), moved to JAX with
  `weights.state_dict_to_jax`, each `run`'s `train_overfit` replaced by
  that module. The ladder's entries are equal exactly. The HBM mode's
  prediction convs run in bf16 in both packages, which round otherwise
  (XLA fuses some float ops in float32; `tests/test_torch_quant.py`), so
  the conf threshold is put in a gap of the port's float and HBM scores
  around the default 0.2 (`chip_smoke.gap_threshold`), where both keep
  the same detections; the counts and the agreement are then equal
  exactly, the score MAD within 2^-8 (one bf16 rounding at these scores)
  and the box MAD within 0.05 px.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import gap_threshold
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))
try:
    import quant_accuracy as jqa
    import torch_quant_accuracy as tqa
finally:
    sys.path.remove(str(SCRIPTS))

VARIANTS = ("ladder-amax", "hbm-amax", "ladder-p99.9", "hbm-p99.9")


def _det_lists(rng, n_images, empty=()):
    out = []
    for b in range(n_images):
        n = 0 if b in empty else int(rng.integers(1, 7))
        xy = rng.uniform(0, 100, (n, 2))
        wh = rng.uniform(5, 40, (n, 2))
        rows = np.concatenate([xy, xy + wh, rng.uniform(0.2, 1, (n, 2)),
                               rng.integers(0, 3, (n, 1))], 1)
        out.append(rows.astype(np.float32))
    return out


def _jitter(rng, dets):
    """A perturbed copy: boxes moved a few px, scores nudged, some rows
    dropped and some classes changed."""
    out = []
    for rows in dets:
        rows = rows.copy()
        rows[:, :4] += rng.normal(0, 3, (len(rows), 4))
        rows[:, 4:6] = np.clip(
            rows[:, 4:6] + rng.normal(0, .05, (len(rows), 2)), 0, 1)
        flip = rng.uniform(size=len(rows)) < 0.2
        rows[flip, 6] = (rows[flip, 6] + 1) % 3
        out.append(rows[rng.uniform(size=len(rows)) > 0.15])
    return out


def test_agreement_equals_jax():
    rng = np.random.default_rng(0)
    for trial in range(6):
        base = _det_lists(rng, 5, empty={trial % 5})
        other = _jitter(rng, base)
        assert tqa.agreement(base, other) == jqa.agreement(base, other)
        assert tqa.agreement(other, base) == jqa.agreement(other, base)
    empty = [np.zeros((0, 7), np.float32)] * 3
    assert tqa.agreement(empty, empty) == jqa.agreement(empty, empty)
    full = _det_lists(rng, 3)
    assert tqa.agreement(full, full) == jqa.agreement(full, full)
    assert tqa.agreement(full, full)["agreement"] == 1.0


def test_overfit_images_and_boxes_bit_equal_jax(monkeypatch):
    import yolox_tpu.core

    def no_step(module, num_classes, **kw):
        return lambda state, x, labels, lr: (state, None)

    monkeypatch.setattr(yolox_tpu.core, "make_train_step", no_step)
    _, jx, jgts, _ = jqa.train_overfit(steps=1, n_images=3, size=96, seed=5)
    module, tx, tgts, cfg = tqa.train_overfit(steps=0, n_images=3, size=96,
                                              seed=5, device="cpu")
    assert tx.dtype == torch.float32 and not module.training
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert tgts == jgts
    x, labels, gts = tqa.overfit_data(3, 96, 5)
    assert gts == jgts
    np.testing.assert_array_equal(
        labels[:, :2], np.asarray([[list(g) for g in per] for per in gts],
                                  np.float32))
    assert not labels[:, 2:].any()
    assert tqa.overfit_lr(0) == 0.0 and tqa.overfit_lr(25) == 0.005
    assert tqa.overfit_lr(50) == 0.02 and tqa.overfit_lr(51) == 0.02


def _amplified_nano():
    from yolox_tpu_torch import YoloxConfig, YoloxModule

    cfg = YoloxConfig.get_named_config("yolox_nano")
    module = YoloxModule.from_config(cfg, rng_seed=0, device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for conv in module.head.obj_preds:
            conv.weight.copy_(torch.from_numpy(
                rng.normal(0, 3e5, conv.weight.shape).astype(np.float32)))
            conv.bias.fill_(-4.0)
        for conv in module.head.cls_preds:
            conv.weight.zero_()
            conv.bias.zero_()
        for conv in module.head.reg_preds:
            conv.weight.copy_(torch.from_numpy(
                rng.normal(0, 1e4, conv.weight.shape).astype(np.float32)))
            conv.bias.zero_()
    module.drop_caches()
    return module, cfg


def _scores(dets):
    return np.concatenate([r[:, 4] * r[:, 5] for r in dets])


def test_run_equals_jax_on_the_same_weights(monkeypatch):
    import jax

    from yolox_tpu import YoloxConfig as JConfig
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu_torch.models.weights import state_dict_to_jax

    module, cfg = _amplified_nano()
    x, _, gts = tqa.overfit_data(2, 128, 0)
    xt = torch.from_numpy(x)
    # the threshold: in a gap of the float and HBM scores near 0.2
    scores = [_scores(tqa._detections(module, cfg, xt, 0.05))]
    for name, qtab, hbm in tqa.int8_variants(module, xt):
        scores.append(_scores(tqa._detections(module, cfg, xt, 0.05, qtab,
                                              hbm)))
    conf, gap = gap_threshold(np.concatenate(scores), 0.15, 0.3)
    assert gap > 0.02, gap

    jcfg = JConfig.get_named_config("yolox_nano")
    jmod = JModule.from_config(jcfg)
    jmod.params = jax.tree.map(jnp.asarray, state_dict_to_jax(
        module.state_dict()))
    monkeypatch.setattr(tqa, "train_overfit",
                        lambda *a, **k: (module, xt, gts, cfg))
    monkeypatch.setattr(jqa, "train_overfit",
                        lambda *a, **k: (jmod, jnp.asarray(x), gts, jcfg))
    got = tqa.run(steps=0, n_images=2, conf=conf, device="cpu")
    want = jqa.run(steps=0, n_images=2, conf=conf)
    assert got["n_float_dets"] == want["n_float_dets"] >= 2
    assert got["model"] == want["model"] == "yolox_nano"
    for name in VARIANTS:
        g, w = got[name], want[name]
        if name.startswith("ladder"):
            assert g == w, name
            continue
        for key in ("n_float", "n_quant", "matched", "agreement"):
            assert g[key] == w[key], (name, g, w)
        assert abs(g["score_mad"] - w["score_mad"]) <= 2.0 ** -8, name
        assert abs(g["box_mad_px"] - w["box_mad_px"]) <= 0.05, name
    assert max(got[n]["agreement"] for n in VARIANTS) >= 0.9


def test_flags_are_jax_flags_plus_device(monkeypatch, capsys):
    seen = {}

    def fake_run(steps, n_images, conf, model, device):
        seen.update(steps=steps, n_images=n_images, conf=conf, model=model,
                    device=device)
        return {"model": model}

    monkeypatch.setattr(tqa, "run", fake_run)
    tqa.main(["--steps", "3", "--images", "2", "--conf", "0.3", "--model",
              "yolox_s", "--device", "cpu"])
    assert seen == {"steps": 3, "n_images": 2, "conf": 0.3,
                    "model": "yolox_s", "device": "cpu"}
    assert capsys.readouterr().out.startswith("QUANT_ACCURACY {")
    with pytest.raises(SystemExit):
        tqa.main(["--device", "tpu"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tqa.train_overfit(steps=0, n_images=1)
