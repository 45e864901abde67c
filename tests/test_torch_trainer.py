"""The port's single-process `Trainer` on the CPU, against the JAX
package's trainer checks (`tests/test_trainer_e2e.py`) and step.

A tiny config (depth 0.33, width 0.125, 64 px, 3 classes, B 4, 2 epochs
of 3 iterations) on the synthetic COCO set (`conftest.coco_dir`), on the
CPU (`args.device = "cpu"`). `no_aug_epochs` 0: the mosaic closes at epoch
index max_epoch - no_aug_epochs - 1 (the reference's rule), so epoch 1
runs Mosaic/MixUp and epoch 2 letterboxes with the L1 loss.

Tolerances: cross-package checkpoint loads compare eval outputs at float32
rtol 1e-4 / atol 1e-3 (the JAX package's own fuse test's); the first
iteration's losses against JAX's `make_train_step` at rtol 1e-4 (the
float32 loss tolerance of `tests/test_torch_train.py`).
"""

import glob
import os
import shutil
from argparse import Namespace

import numpy as np
import pytest
import torch

from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu_torch import YoloxConfig
from yolox_tpu_torch.models.weights import state_dict_from_jax
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)


def _tiny(cls, coco_dir, out_dir):
    class Tiny(cls):
        def __init__(self):
            super().__init__("tiny_e2e")
            self.num_classes = 3
            self.depth, self.width = 0.33, 0.125
            self.input_size = self.test_size = (64, 64)
            self.max_epoch = 2
            self.warmup_epochs = 1
            self.no_aug_epochs = 0
            self.eval_interval = 1
            self.print_interval = 2
            self.data_num_workers = 0
            self.save_history_ckpt = False
            self.multiscale_range = 0
            self.lane_fold = False  # the JAX package's TPU layout
            self.data_dir = coco_dir
            self.output_dir = out_dir

        def get_eval_dataset(self, **kwargs):
            data = __import__(cls.__module__.split(".")[0] + ".data",
                              fromlist=["CocoDataset"])
            return data.CocoDataset(
                data_dir=self.data_dir, json_file=self.train_ann,
                name="train2017", img_size=self.test_size,
                preproc=data.ValTransform())

    return Tiny()


def _args(**kw):
    base = dict(batch_size=4, fp16=False, cache=None, logger="tensorboard",
                ckpt=None, resume=False, start_epoch=None, name="run",
                device="cpu")
    base.update(kw)
    return Namespace(**base)


def _recording(trainer):
    """Record (progress, lr, total_loss) of every iteration."""
    trainer.record = []
    one_iter = trainer.train_one_iter

    def wrapped():
        one_iter()
        trainer.record.append((trainer.progress_in_iter,
                               trainer.meter["lr"].latest,
                               trainer.meter["total_loss"].latest))

    trainer.train_one_iter = wrapped
    return trainer


@pytest.fixture(scope="module")
def trained(coco_dir, tmp_path_factory):
    """One full run (eval every epoch), shared by the read-only checks."""
    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path_factory.mktemp("out")))
    trainer = _recording(cfg.get_trainer(_args()))
    trainer.train()
    return cfg, trainer


def test_checkpoints_losses_and_schedule(trained):
    cfg, trainer = trained
    run_dir = trainer.file_name
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(run_dir, "*_ckpt.pth")))
    for want in ("latest_ckpt.pth", "last_mosaic_epoch_ckpt.pth",
                 "last_epoch_ckpt.pth"):
        assert want in names
    assert os.path.exists(os.path.join(run_dir, "train_log.txt"))
    assert len(trainer.record) == trainer.max_iter * cfg.max_epoch == 6
    assert all(np.isfinite(loss) for _, _, loss in trainer.record)
    sched = cfg.get_lr_scheduler(cfg.basic_lr_per_img * 4, trainer.max_iter)
    from yolox_tpu.utils.lr_scheduler import LRScheduler as JScheduler

    jsched = JScheduler("yoloxwarmcos", cfg.basic_lr_per_img * 4,
                        trainer.max_iter, cfg.max_epoch, warmup_epochs=1,
                        warmup_lr_start=0, no_aug_epochs=0,
                        min_lr_ratio=cfg.min_lr_ratio)
    for progress, lr, _ in trainer.record:
        assert lr == sched.update_lr(progress + 1) == \
            jsched.update_lr(progress + 1)
    assert trainer.use_l1 and trainer.no_aug
    assert trainer.best_ap >= 0.0
    assert trainer.train_state.ema.updates == 6
    # batches are pinned (by the loader's thread) only for a CUDA device
    assert trainer.train_loader.pin_memory is False


def test_checkpoint_loads_into_jax_strict(trained):
    """The port's checkpoint through JAX's `load_checkpoint` into JAX's
    YoloxModule (strict key and shape check), with equal outputs."""
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu.utils.checkpoint import load_checkpoint as j_load

    cfg, trainer = trained
    path = os.path.join(trainer.file_name, "latest_ckpt.pth")
    jcfg = _tiny(JConfig, cfg.data_dir, cfg.output_dir)
    jmodule = JModule.from_config(jcfg)
    ckpt = j_load(path)
    jmodule.load_params(ckpt["model"])
    x = np.random.default_rng(0).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jmodule(x))
    got = trainer._eval_module()(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert ckpt["start_epoch"] == cfg.max_epoch
    # the momentum is in the JAX package's layout (HWIO kernels)
    assert set(ckpt["momentum_buf"]) == {"backbone", "head"}


def test_jax_checkpoint_loads_into_port_strict(trained, tmp_path):
    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu.utils.checkpoint import save_checkpoint as j_save
    from yolox_tpu_torch import YoloxModule
    from yolox_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, _ = trained
    jmodule = JModule.from_config(_tiny(JConfig, cfg.data_dir, ""),
                                  rng_seed=5)
    j_save({"model": jmodule.params, "start_epoch": 3, "best_ap": 0.25},
           False, str(tmp_path), "jax")
    ckpt = load_checkpoint(str(tmp_path / "jax_ckpt.pth"))
    module = YoloxModule.from_config(cfg, device="cpu")
    module.load_params(ckpt["model"])  # strict
    x = np.random.default_rng(1).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(module(x).numpy(), np.asarray(jmodule(x)),
                               rtol=1e-4, atol=1e-3)
    assert (ckpt["start_epoch"], ckpt["best_ap"]) == (3, 0.25)


def test_resume(trained, tmp_path):
    cfg, trainer = trained
    out = str(tmp_path / "out")
    shutil.copytree(os.path.dirname(trainer.file_name), out)
    cfg2 = _tiny(YoloxConfig, cfg.data_dir, out)
    cfg2.max_epoch = 3
    trainer2 = _recording(cfg2.get_trainer(_args(resume=True)))
    trainer2.before_train()
    assert trainer2.start_epoch == 2
    assert trainer2.train_state.ema.updates == 2 * trainer2.max_iter
    # resumed weights and momentum
    want = torch.load(os.path.join(out, "run", "latest_ckpt.pth"),
                      weights_only=True)
    for k, v in trainer2.module.state_dict().items():
        torch.testing.assert_close(v, want["model"][k], rtol=0, atol=0)
    mom = state_dict_from_jax(want["momentum_buf"])
    opt = trainer2.train_state.optimizer
    for name, p in trainer2.module.named_parameters():
        torch.testing.assert_close(opt.state[p]["momentum_buffer"],
                                   mom[name], rtol=0, atol=0)
    trainer2.train_in_epoch()
    trainer2.after_train()
    assert trainer2.epoch == 2 and len(trainer2.record) == trainer2.max_iter
    assert all(np.isfinite(loss) for _, _, loss in trainer2.record)


def test_training_with_frozen_backbone(coco_dir, tmp_path):
    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path))
    cfg.freeze_prefix = "backbone.backbone"
    cfg.max_epoch, cfg.eval_interval = 1, 10
    trainer = cfg.get_trainer(_args())
    trainer.before_train()
    before = {k: v.clone() for k, v in trainer.module.named_parameters()}
    trainer.train_in_epoch()
    trainer.after_train()
    changed = {k for k, v in trainer.module.named_parameters()
               if not torch.equal(v, before[k])}
    assert changed, "training should have updated something"
    assert all(not k.startswith("backbone.backbone") for k in changed)


def test_training_with_device_augment(coco_dir, tmp_path):
    """Epoch 1 augments on the device from raw tiles; epoch 2 switches to
    the host letterbox loader with the L1 loss."""
    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path))
    cfg.device_augment = True
    cfg.eval_interval = 10
    trainer = _recording(cfg.get_trainer(_args()))
    calls = []
    trainer.before_train()
    assert trainer._device_augment and trainer._step_aug is not None
    step_aug = trainer._step_aug
    trainer._step_aug = lambda *a, **k: calls.append(1) or step_aug(*a, **k)
    trainer.train_in_epoch()
    trainer.after_train()
    assert len(calls) == trainer.max_iter
    assert trainer._device_augment is False and trainer.use_l1 is True
    assert all(np.isfinite(loss) for _, _, loss in trainer.record)


def test_multiscale_resize_scales_images_and_targets(coco_dir, tmp_path):
    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path))
    trainer = cfg.get_trainer(_args())
    trainer.before_train()
    trainer._current_size = (32, 32)  # half of the 64 px input
    x = np.zeros((2, 64, 64, 3), np.float32)
    x[:, :32, :32] = 200.0
    t = np.zeros((2, 120, 5), np.float32)
    t[:, 0] = [1, 32, 16, 20, 10]   # cls, cx, cy, w, h in 64 px space
    xr, tr = trainer._multiscale_resize(torch.from_numpy(x),
                                        torch.from_numpy(t))
    xr, tr = xr.numpy(), tr.numpy()
    trainer.after_train()
    assert xr.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(tr[:, 0], np.tile([1, 16, 8, 10, 5], (2, 1)),
                               rtol=1e-5)
    assert xr[0, 8, 8].mean() > 150 and xr[0, 24, 24].mean() < 50


def test_multiscale_sizes_and_draws_equal_jax():
    for name in ("yolox_s", "yolox_tiny"):
        cfg, jcfg = (c.get_named_config(name) for c in (YoloxConfig, JConfig))
        assert cfg.multiscale_sizes() == jcfg.multiscale_sizes()
        r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
        draws = [cfg.random_resize(r1) for _ in range(200)]
        assert draws == [jcfg.random_resize(r2) for _ in range(200)]
        assert set(draws) <= set(cfg.multiscale_sizes())
    sizes = YoloxConfig.get_named_config("yolox_s").multiscale_sizes()
    assert len(sizes) == 11 and (640, 640) in sizes
    assert min(s[0] for s in sizes) == 480 and max(s[0] for s in sizes) == 800


def test_first_iteration_losses_equal_jax_step(coco_dir, tmp_path):
    """The trainer's first iteration: JAX's loader gives the same batch,
    and JAX's `make_train_step` from the same parameters gives the same
    losses."""
    import jax.numpy as jnp

    from yolox_tpu import YoloxModule as JModule
    from yolox_tpu.core import init_train_state as j_init
    from yolox_tpu.core import make_train_step as j_make

    jcfg = _tiny(JConfig, coco_dir, str(tmp_path / "j"))
    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path / "t"))
    cfg.seed = jcfg.seed = 3
    jmodule = JModule.from_config(jcfg, rng_seed=11)
    port_model = cfg.get_model

    def from_jax(rng_seed=0, device=None):
        module = port_model(rng_seed=rng_seed, device=device)
        module.load_state_dict(state_dict_from_jax(jmodule.params))
        return module

    cfg.get_model = from_jax
    trainer = cfg.get_trainer(_args())
    trainer.before_train()
    batch = trainer.prefetcher._next
    jloader = jcfg.get_data_loader(4)
    jimgs, jtargets, _, _ = next(iter(jloader))
    jloader.close()
    np.testing.assert_array_equal(batch[0].numpy(), jimgs)
    assert batch[0].dtype == torch.float32
    np.testing.assert_array_equal(batch[1].numpy(), jtargets)

    trainer.iter = 0
    trainer.train_one_iter()
    got = {k: trainer.meter[k].latest for k in
           ("total_loss", "iou_loss", "conf_loss", "cls_loss", "l1_loss",
            "num_fg")}
    lr = trainer.meter["lr"].latest
    trainer.after_train()

    step = j_make(jmodule, jcfg.num_classes, use_l1=False)
    _, want = step(j_init(jmodule.params), jnp.asarray(jimgs),
                   jnp.asarray(jtargets), jnp.float32(lr))
    for k, v in got.items():
        np.testing.assert_allclose(v, float(want[k]), rtol=1e-4, err_msg=k)
    assert got["num_fg"] > 0


def test_preemption_writes_resume_checkpoint(coco_dir, tmp_path):
    """SIGTERM mid-epoch: a resume checkpoint that redoes the epoch, then
    `train` returns cleanly and the previous handler is back."""
    import signal

    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path))
    trainer = _recording(cfg.get_trainer(_args()))
    one_iter = trainer.train_one_iter

    def preempted():
        one_iter()
        if trainer.progress_in_iter == 1:
            # the handler the trainer installed, as the signal would run it
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), handler
            handler(signal.SIGTERM, None)

    trainer.train_one_iter = preempted
    before = signal.getsignal(signal.SIGTERM)
    trainer.train()
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(trainer.record) == 2
    ckpt = torch.load(os.path.join(trainer.file_name, "latest_ckpt.pth"),
                      weights_only=True)
    assert ckpt["start_epoch"] == 0


def test_profiler_trace(coco_dir, tmp_path, monkeypatch):
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv("YOLOX_PROFILE_DIR", str(prof_dir))
    monkeypatch.setenv("YOLOX_PROFILE_START", "1")
    monkeypatch.setenv("YOLOX_PROFILE_ITERS", "1")
    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path / "out"))
    cfg.max_epoch, cfg.eval_interval = 1, 10
    trainer = cfg.get_trainer(_args())
    trainer.train()
    assert (prof_dir / "trace_rank0.json").stat().st_size > 0
    names = {e.key for e in trainer.profiler.key_averages()}
    assert any("conv" in n for n in names)
    from yolox_tpu_torch.utils.trace import TRAIN_SPANS

    assert set(TRAIN_SPANS) <= names


def test_trainer_needs_a_device_or_cpu(coco_dir, tmp_path, monkeypatch):
    """No card and no explicit device: the trainer raises, it does not fall
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny(YoloxConfig, coco_dir, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.get_trainer(_args(device=None))
