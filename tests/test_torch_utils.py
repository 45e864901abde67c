"""The port's training utilities against the JAX package's, on the CPU:
the eval-BN fold (`fuse_model`) against the unfused module and JAX's
`fuse_model_params` (float32: rtol 1e-4 / atol 1e-3 on outputs, the JAX
package's own fold test; the folded parameters within 1e-6 relative, both
fold in float64 and round once), `get_model_info` against JAX's, the
meters, the logger's stream capture, the checkpoint round trip, and the
mlflow / wandb loggers on fake backends (as `tests/test_loggers.py`).
"""

import copy
import sys
import types

import numpy as np
import pytest
import torch

from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu import YoloxModule as JModule
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.models.weights import state_dict_to_jax
from yolox_tpu_torch.utils import (
    MeterBuffer,
    adjust_status,
    count_params,
    freeze_mask,
    fuse_model,
    get_model_info,
    load_checkpoint,
    load_ckpt,
    save_checkpoint,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)


def _small(cls):
    cfg = cls.get_named_config("yolox_s")
    cfg.depth, cfg.width, cfg.num_classes = 0.33, 0.125, 3
    return cfg


def _with_bn_stats(module, seed=0):
    """Random BN gammas, betas and running statistics (init has identity
    BN, which a fold would pass trivially)."""
    rng = np.random.default_rng(seed)
    sd = module.state_dict()
    for k, v in sd.items():
        if ".bn." not in k or not v.is_floating_point():
            continue
        if k.endswith("running_var"):
            new = rng.uniform(0.5, 2.0, v.shape)
        elif k.endswith("weight"):
            new = rng.uniform(0.5, 1.5, v.shape)
        else:
            new = rng.normal(0, 0.2, v.shape)
        sd[k] = torch.from_numpy(new.astype(np.float32))
    module.load_state_dict(sd)
    return module


def test_fuse_model_matches_unfused_and_jax():
    from yolox_tpu.utils.model_utils import fuse_model_params

    module = _with_bn_stats(YoloxModule.from_config(_small(YoloxConfig),
                                                    device="cpu"))
    x = np.random.default_rng(1).uniform(0, 255, (1, 128, 128, 3)).astype(
        np.float32)
    want = module(x).numpy()
    fused = fuse_model(copy.deepcopy(module))
    np.testing.assert_allclose(fused(x).numpy(), want, rtol=1e-4, atol=1e-3)

    jmodule = JModule.from_config(_small(JConfig))
    jfused = fuse_model_params(state_dict_to_jax(module.state_dict()))
    from yolox_tpu_torch.models.weights import nested_to_flat

    jflat = nested_to_flat(jfused)
    jsd = nested_to_flat(state_dict_to_jax(fused.state_dict()))
    for k, v in jflat.items():
        np.testing.assert_allclose(jsd[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(np.asarray(jmodule(x, params=jfused)), want,
                               rtol=1e-4, atol=1e-3)


def test_get_model_info_equals_jax():
    """Parameters equal JAX's count exactly; the multiply-adds of a 256 px
    forward within 5% of JAX's (JAX reads XLA's cost analysis of its
    compiled program, which counts some fused elementwise work and not
    others; the port counts every conv and matmul multiply-add, thop's
    convention)."""
    import jax
    import jax.numpy as jnp
    from torch.utils.flop_counter import FlopCounterMode

    from yolox_tpu.utils.model_utils import count_params as j_count
    from yolox_tpu.utils.model_utils import get_model_info as j_info

    cfg, jcfg = _small(YoloxConfig), _small(JConfig)
    module = YoloxModule.from_config(cfg, device="cpu")
    jmodule = JModule.from_config(jcfg)
    assert count_params(module) == j_count(jmodule.params)
    got, want = get_model_info(module, (256, 256)), j_info(jmodule,
                                                           (256, 256))
    assert got.split(",")[0] == want.split(",")[0]

    def fwd(p, x):
        return jmodule.head(p["head"], jmodule.backbone(p["backbone"], x))

    cost = jax.jit(fwd).lower(jmodule.params, jnp.zeros(
        (1, 256, 256, 3))).compile().cost_analysis()
    with FlopCounterMode(display=False) as counter:
        module(torch.zeros(1, 256, 256, 3))
    port, jax_macs = counter.get_total_flops() / 2, cost["flops"] / 2
    assert abs(port - jax_macs) <= 0.05 * jax_macs, (port, jax_macs)
    assert got.endswith(f"Gflops: {port / 1e9:.2f}")


def test_freeze_mask_and_adjust_status():
    module = YoloxModule.from_config(_small(YoloxConfig), device="cpu")
    mask = freeze_mask(module, "backbone.backbone")
    assert set(mask) == {n for n, _ in module.named_parameters()}
    assert all((v == 0.0) == k.startswith("backbone.backbone")
               for k, v in mask.items())
    module.train()
    module.head.eval()
    with adjust_status(module, training=False) as m:
        assert m is module and not any(x.training for x in module.modules())
    assert module.training and module.backbone.training
    assert not module.head.training


def test_meter_buffer():
    meters = MeterBuffer(window_size=3)
    for i in range(5):
        meters.update(iter_time=float(i), total_loss=torch.tensor(2.0 * i),
                      lr=np.float64(0.1))
    assert meters["iter_time"].latest == 4.0
    assert meters["iter_time"].avg == 3.0 and meters["iter_time"].median == 3.0
    assert meters["iter_time"].global_avg == 2.0
    assert meters["total_loss"].latest == 8.0
    assert set(meters.get_filtered_meter("time")) == {"iter_time"}
    meters.clear_meters()
    assert meters["iter_time"].latest is None
    assert meters["iter_time"].global_avg == 2.0
    meters.reset()
    assert meters["iter_time"].total == 0.0


def test_setup_logger_captures_prints(tmp_path):
    from yolox_tpu_torch.utils.logger import restore_sys_output, setup_logger

    orig_out, orig_err = sys.stdout, sys.stderr
    try:
        setup_logger(str(tmp_path), rank=0, filename="log.txt",
                     capture_std=True)
        print("hello-from-print")
        sys.stdout.flush()
    finally:
        restore_sys_output()
        setup_logger(rank=1)  # detach the file handler
    assert sys.stdout is orig_out and sys.stderr is orig_err
    assert "hello-from-print" in (tmp_path / "log.txt").read_text()


def test_checkpoint_round_trip(tmp_path):
    module = YoloxModule.from_config(_small(YoloxConfig), device="cpu")
    mom = {"backbone": {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    save_checkpoint({"model": module.state_dict(), "start_epoch": 4,
                     "best_ap": 0.5, "curr_ap": None, "momentum_buf": mom},
                    True, str(tmp_path), "latest")
    for name in ("latest_ckpt.pth", "best_ckpt.pth"):
        ckpt = load_checkpoint(str(tmp_path / name))
        assert (ckpt["start_epoch"], ckpt["best_ap"], ckpt["curr_ap"]) == \
            (4, 0.5, None)
        np.testing.assert_array_equal(ckpt["momentum_buf"]["backbone"]["x"],
                                      mom["backbone"]["x"])
        fresh = YoloxModule.from_config(_small(YoloxConfig), rng_seed=9,
                                        device="cpu")
        fresh.load_params(ckpt["model"])
        for k, v in module.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
    # shape-tolerant load: a 5-class checkpoint keeps the 3-class head
    other = _small(YoloxConfig)
    other.num_classes = 5
    five = YoloxModule.from_config(other, rng_seed=2, device="cpu")
    target = YoloxModule.from_config(_small(YoloxConfig), device="cpu")
    keep = target.head.cls_preds[0].weight.clone()
    load_ckpt(target, five.state_dict())
    assert torch.equal(target.head.cls_preds[0].weight, keep)
    assert torch.equal(target.head.reg_preds[0].weight,
                       five.head.reg_preds[0].weight)


class _FakeRun:
    def __init__(self):
        self.id = "fake123"
        self.logged, self.artifacts = [], []
        self.config = self
        self.finished = False

    def update(self, cfg, allow_val_change=False):
        self.cfg = cfg

    def log(self, metrics, step=None):
        self.logged.append((metrics, step))

    def log_artifact(self, artifact, aliases=None):
        self.artifacts.append((artifact, aliases))

    def finish(self):
        self.finished = True


class _FakeTable:
    def __init__(self, columns=None):
        self.columns, self.rows = columns, []

    def add_data(self, *row):
        self.rows.append(row)


class _FakeArtifact:
    def __init__(self, name=None, type=None, metadata=None):
        self.name, self.type, self.metadata = name, type, metadata
        self.files = []

    def add_file(self, path, name=None):
        self.files.append((path, name))


def test_wandb_logger_with_fake(monkeypatch, tmp_path):
    from yolox_tpu_torch.utils.wandb_logger import WandbLogger

    monkeypatch.setitem(sys.modules, "wandb", None)
    assert not WandbLogger().enabled
    run = _FakeRun()
    mod = types.ModuleType("wandb")
    mod.init = lambda **kw: run
    mod.Table, mod.Artifact = _FakeTable, _FakeArtifact
    monkeypatch.setitem(sys.modules, "wandb", mod)
    monkeypatch.setenv("YOLOX_WANDB_LOG_CHECKPOINTS", "true")
    wl = WandbLogger()
    assert wl.enabled
    wl.setup(exp=YoloxConfig.get_named_config("yolox_nano"))
    assert run.cfg["num_classes"] == 80
    wl.log_metrics({"train/loss": 3.5, "skip": "notanumber"}, step=7)
    assert run.logged[-1] == ({"train/loss": 3.5}, 7)
    (tmp_path / "latest_ckpt.pth").write_bytes(b"x")
    wl.save_checkpoint(str(tmp_path), "latest", is_best=True,
                       metadata={"epoch": 3})
    art, aliases = run.artifacts[-1]
    assert "best" in aliases and art.metadata["epoch"] == 3
    wl.finish()
    assert run.finished


def test_mlflow_logger_with_fake(monkeypatch, tmp_path):
    from yolox_tpu_torch.utils.mlflow_logger import MlflowLogger

    monkeypatch.setitem(sys.modules, "mlflow", None)
    assert not MlflowLogger().enabled
    calls = {"params": {}, "metrics": [], "artifacts": [], "ended": False}
    mod = types.ModuleType("mlflow")
    mod.set_tracking_uri = lambda uri: calls.__setitem__("uri", uri)
    mod.set_experiment = lambda name: calls.__setitem__("experiment", name)
    mod.start_run = lambda **kw: types.SimpleNamespace(
        info=types.SimpleNamespace(run_id="r1"), **kw)
    mod.set_tags = lambda t: None
    mod.log_params = lambda p: calls["params"].update(p)
    mod.log_metrics = lambda m, step=None: calls["metrics"].append((m, step))
    mod.log_artifact = lambda p: calls["artifacts"].append(p)
    mod.end_run = lambda: calls.__setitem__("ended", True)
    monkeypatch.setitem(sys.modules, "mlflow", mod)
    monkeypatch.setenv("MLFLOW_TRACKING_URI", "file:///tmp/mlruns")
    monkeypatch.setenv("YOLOX_MLFLOW_LOG_MODEL_ARTIFACTS", "True")
    monkeypatch.setenv("YOLOX_MLFLOW_LOG_MODEL_PER_n_EPOCHS", "3")
    cfg = YoloxConfig.get_named_config("yolox_nano")
    ml = MlflowLogger()
    ml.setup(exp=cfg)
    assert calls["uri"] == "file:///tmp/mlruns"
    assert calls["params"]["num_classes"] == "80"
    ml.on_log(None, cfg, 3, {"train/loss": 2.0, "note": "skip-me"})
    assert calls["metrics"][-1] == ({"train_loss": 2.0}, 3)
    (tmp_path / "latest_ckpt.pth").write_bytes(b"x")
    ml.save_checkpoints(None, cfg, str(tmp_path), 3, {}, False)
    assert str(tmp_path / "latest_ckpt.pth") in calls["artifacts"]
    ml.on_train_end(None, file_name=str(tmp_path), metadata={"best_ap": 0.1})
    assert calls["ended"] and calls["params"]["final_best_ap"] == "0.1"


def test_trainer_imports_a_tracker_only_when_chosen(monkeypatch):
    """The trackers' modules load when `args.logger` names them, not with
    the trainer."""
    for name in ("mlflow_logger", "wandb_logger"):
        monkeypatch.delitem(sys.modules, f"yolox_tpu_torch.utils.{name}",
                            raising=False)
    import yolox_tpu_torch.core.trainer  # noqa: F401

    assert "yolox_tpu_torch.utils.mlflow_logger" not in sys.modules
    assert "yolox_tpu_torch.utils.wandb_logger" not in sys.modules
