"""The port's train profiler (`scripts/torch_profile_train.py`) against
the JAX package on the CPU: its "fwd + SimOTA loss" value (and the
backward stage's, which adds 1e-20 of the gradients) equals JAX's
`compute_losses(apply_train(...))["total_loss"]` on the same weights,
pixels and labels (yolox-s at depth 0.33, width 0.125, 64 px, B 2,
float32, rtol 1e-4: float32 convs in another order through train-mode
BN), and its `main` prints all five rows on the CPU.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))
try:
    import torch_profile_train as tpt
finally:
    sys.path.remove(str(SCRIPTS))

TRAIN_FIELDS = ("stage", "checksum", "launches", "events_ms", "device_ms",
                "kernel_ms", "img_per_s", "busy", "peak_gb")
RTOL = 1e-4


def _jax_fwd_loss(jmod, x, labels, num_classes):
    from yolox_tpu.models.assign import compute_losses
    from yolox_tpu.models.blocks import BNCollector

    out = jmod.apply_train(jmod.params, jnp.asarray(x), BNCollector(),
                           lane_fold=False)
    return float(compute_losses(out, jnp.asarray(labels),
                                num_classes)["total_loss"])


def _small_configs():
    from yolox_tpu import YoloxConfig as JConfig
    from yolox_tpu_torch import YoloxConfig

    out = []
    for cls in (JConfig, YoloxConfig):
        cfg = cls.get_named_config("yolox_s")
        cfg.depth, cfg.width = 0.33, 0.125
        cfg.input_size = cfg.test_size = (64, 64)
        out.append(cfg)
    return out


def test_train_fwd_loss_stage_equals_jax():
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.models.weights import state_dict_from_jax

    jcfg, cfg = _small_configs()
    jmod = JModule.from_config(jcfg, rng_seed=5)
    module = YoloxModule.from_config(cfg, device="cpu")
    module.load_params(state_dict_from_jax(jmod.params))
    x, labels = tpt.train_inputs(2, 64)
    stages = dict(tpt.train_stages(module, torch.from_numpy(x),
                                   torch.from_numpy(labels), cfg.num_classes,
                                   compute_dtype=torch.float32))
    got = float(stages["fwd + SimOTA loss"]())
    want = _jax_fwd_loss(jmod, x, labels, jcfg.num_classes)
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the backward adds only 1e-20 of the gradients to the same loss
    np.testing.assert_allclose(float(stages["fwd + loss + grad (bwd)"]()),
                               want, rtol=RTOL)


def test_train_main_prints_every_stage_on_the_cpu(monkeypatch, capsys):
    cfg = _small_configs()[1]
    monkeypatch.setattr(tpt, "named_config", lambda model: cfg)
    res = tpt.main(["--device", "cpu", "--batch", "2", "--iters", "1",
                    "--fused-bwd"])
    out = capsys.readouterr().out
    names = [s["stage"] for s in res["stages"]]
    assert names == ["fwd eval-mode (bf16)", "fwd train-mode (BN batch stats)",
                     "fwd + SimOTA loss", "fwd + loss + grad (bwd)",
                     "full train step"]
    for s in res["stages"]:
        assert set(TRAIN_FIELDS) <= set(s), s
        assert s["stage"] in out and np.isfinite(s["checksum"])
        assert s["events_ms"] is None and s["device_ms"] is None
        assert s["kernel_ms"] is None and s["peak_gb"] is None
    assert res["fused_bwd"] and res["size"] == 64
