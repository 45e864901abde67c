"""Trainer, on one device or data-parallel across processes: the PyTorch
counterpart of the JAX package's `yolox_tpu/core/trainer.py` (the
reference's `yolox/core/trainer.py`).

The same lifecycle (`before/after_{train,epoch,iter}` around the epoch and
iteration loops) and schedule: mosaic closed and the L1 loss switched on
at epoch `max_epoch - no_aug_epochs - 1` (0-based), the LR set every
iteration, the EMA model evaluated every `eval_interval` epochs with the
best AP tracked, a new multiscale size every 10 iterations, and upstream
`.pth` checkpoints (latest, last_mosaic_epoch, last_epoch, best, per
epoch) that resume. The step is `core/train_step.py`'s: `make_train_step`
with and without L1, and with `device_augment` `make_augmented_train_step`
(the augmentation runs on the device, the loader serves raw tiles), both
with `fused_bwd = config.fused_conv_bwd`. `args.fp16` means bf16 compute
with float32 master weights, as in the JAX package.

The device is `args.device`, `cuda` when it is not given; with no CUDA
device and no explicit "cpu" the trainer raises. XLA's multiscale warm-up
compiles have no counterpart: eager PyTorch compiles nothing.

Data parallelism: when a default `torch.distributed` process group is
initialized (`parallel/mesh.py::init_distributed`; the CLI's `-d`,
`--num_machines`, `--dist-url`), `-b` is the global batch and each rank
trains on `batch // world_size` images of its own (the rank-strided
sampler), with the gradients, BN statistics and logged losses averaged
over the ranks every step (`make_train_step(group=...)`); each rank
augments on the device from its own generator. Evaluation runs on every
rank and gathers the detections to rank 0. Only rank 0 writes the
output directory: log file, tracker, checkpoints and `best_ckpt`. The
ranks wait for each other once before the first step.

SIGTERM (preemption) on any rank writes a resume checkpoint that redoes
the interrupted epoch and ends `train` cleanly on every rank at the same
iteration: at each iteration boundary the ranks all-reduce their notice
flags with MAX (the JAX package's `reached_preemption_sync_point`).
`YOLOX_PROFILE_DIR` (with `YOLOX_PROFILE_START`, `YOLOX_PROFILE_ITERS`)
traces those iterations with torch.profiler into a Chrome trace there,
one file a rank.
"""

from __future__ import annotations

import datetime
import os
import signal
import threading
import time

import numpy as np
import torch

from yolox_tpu_torch.config import YoloxConfig
from yolox_tpu_torch.models.weights import (
    state_dict_from_jax,
    state_dict_to_jax,
)
from yolox_tpu_torch.models.yolox import resolve_device
from yolox_tpu_torch.parallel.mesh import any_rank, process_rank_and_count
from yolox_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_ckpt,
    save_checkpoint,
)
from yolox_tpu_torch.utils.logger import (
    logger,
    restore_sys_output,
    setup_logger,
)
from yolox_tpu_torch.utils.metric import (
    MeterBuffer,
    device_mem_usage,
    mem_usage,
)
from yolox_tpu_torch.utils.model_utils import adjust_status, get_model_info


class PreemptionExit(Exception):
    """Raised at an iteration boundary after a preemption notice, once the
    resume checkpoint is written; `Trainer.train` ends cleanly on it."""


class Trainer:
    def __init__(self, config: YoloxConfig, args):
        self.device = resolve_device(getattr(args, "device", None))
        self.exp = config
        self.args = args

        self.max_epoch = config.max_epoch
        self.use_bf16 = bool(getattr(args, "fp16", False))
        self.rank, self.world_size = process_rank_and_count()
        self.is_distributed = self.world_size > 1
        if args.batch_size % self.world_size:
            raise ValueError(
                f"batch size {args.batch_size} must divide over the "
                f"{self.world_size} ranks (each takes batch / world)")
        self.use_model_ema = config.ema
        self.save_history_ckpt = config.save_history_ckpt

        self.input_size = config.input_size
        self.best_ap = 0.0

        self.meter = MeterBuffer(window_size=config.print_interval)
        self.file_name = os.path.join(
            config.output_dir, getattr(args, "name", None) or config.name)
        if self.rank == 0:
            os.makedirs(self.file_name, exist_ok=True)
        # raw prints land in train_log.txt as log records (the reference's
        # `logger.py:32-78`); after_train restores the streams
        setup_logger(self.file_name, rank=self.rank,
                     filename="train_log.txt", mode="a", capture_std=True)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def train(self):
        self.before_train()
        try:
            self.train_in_epoch()
        except PreemptionExit:
            logger.info("preemption: resume checkpoint written, exiting "
                        "cleanly (restart with --resume)")
        except Exception:
            logger.exception("Exception in training")
            raise
        finally:
            self.after_train()

    def train_in_epoch(self):
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.train_in_iter()
            self.after_epoch()

    def train_in_iter(self):
        for self.iter in range(self.max_iter):
            self.before_iter()
            self.train_one_iter()
            self.after_iter()
            self._maybe_handle_preemption()

    # ---------------- preemption ----------------

    def _install_preemption_handler(self):
        self._sigterm = threading.Event()
        self._prev_sigterm = None
        if threading.current_thread() is threading.main_thread():
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, lambda *_: self._sigterm.set())

    def _restore_preemption_handler(self):
        if getattr(self, "_prev_sigterm", None) is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def _maybe_handle_preemption(self):
        preempted = self._sigterm.is_set()
        if self.is_distributed:
            # every rank takes the same decision at the same boundary
            preempted = any_rank(preempted)
        if not preempted:
            return
        logger.info(
            f"preemption notice at epoch {self.epoch + 1} iter "
            f"{self.iter + 1}: checkpointing with the interrupted epoch "
            f"marked for redo")
        # the interrupted epoch is redone on resume (start_epoch stays at
        # the current epoch): some data is seen twice, none is skipped
        self.save_ckpt(ckpt_name="latest", start_epoch=self.epoch)
        raise PreemptionExit

    # ---------------- profiling ----------------

    def _maybe_profile(self):
        profile_dir = os.environ.get("YOLOX_PROFILE_DIR")
        if not profile_dir:
            return
        from torch.profiler import ProfilerActivity, profile

        start = int(os.environ.get("YOLOX_PROFILE_START", "10"))
        n = int(os.environ.get("YOLOX_PROFILE_ITERS", "10"))
        it = self.progress_in_iter
        if it == start:
            logger.info(f"profiler: tracing iters [{start}, {start + n}) "
                        f"to {profile_dir}")
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=activities)
            self.profiler.__enter__()
            self._profiling = True
            self._profile_dir = profile_dir
        elif getattr(self, "_profiling", False) and it >= start + n:
            self._stop_profiler()

    def _stop_profiler(self):
        if not getattr(self, "_profiling", False):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.__exit__(None, None, None)
        self._profiling = False
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, f"trace_rank{self.rank}.json")
        self.profiler.export_chrome_trace(path)
        logger.info(f"profiler: trace written to {path}")

    # ---------------- one iteration ----------------

    def train_one_iter(self):
        iter_start_time = time.time()
        batch = self.prefetcher.next()
        if batch is None:  # the infinite sampler never ends
            return
        inps, targets, infos, _ = batch
        data_end_time = time.time()

        lr = self.lr_scheduler.update_lr(self.progress_in_iter + 1)
        if self._first_step_pending:
            self._first_step_pending = False
            logger.info("data-parallel: ranks meet before the first step")
            torch.distributed.barrier()
        if self._device_augment:
            hw = np.stack([np.asarray(i) for i in infos]).astype(np.float32)
            self._aug_gen.manual_seed(augment_seed(
                self.exp.seed, self.rank, self.progress_in_iter))
            self.train_state, outputs = self._step_aug(
                self.train_state, inps, hw, targets.float(), self._aug_gen,
                lr, tuple(self.input_size), tuple(self._current_size))
        else:
            inps, targets = self._multiscale_resize(inps, targets)
            step = self._step_l1 if self.use_l1 else self._step
            self.train_state, outputs = step(self.train_state, inps,
                                             targets, lr)

        iter_end_time = time.time()
        self.meter.update(
            iter_time=iter_end_time - iter_start_time,
            data_time=data_end_time - iter_start_time,
            lr=lr,
            **outputs,
        )
        self._check_finite_loss()

    def _check_finite_loss(self):
        """Stop at once on a non-finite loss, with its breakdown, while
        `latest_ckpt.pth` still holds the last finite epoch."""
        total = self.meter["total_loss"].latest
        if total is None or np.isfinite(total):
            return
        breakdown = ", ".join(
            f"{k}: {v.latest}" for k, v in
            self.meter.get_filtered_meter("loss").items())
        raise FloatingPointError(
            f"non-finite training loss at epoch {self.epoch + 1} iter "
            f"{self.iter + 1} ({breakdown}, lr "
            f"{self.meter['lr'].latest:.3e}). Training aborted before the "
            f"state could be checkpointed; resume from the last epoch "
            f"checkpoint with --resume. Typical causes: learning rate too "
            f"high for the batch size, corrupt/degenerate labels.")

    def _multiscale_resize(self, inps, targets):
        """The batch bilinearly resized to the current multiscale size,
        its (cls, cx, cy, w, h) targets scaled with it."""
        from yolox_tpu_torch.core.train_step import _multiscale_resize

        inps = torch.as_tensor(inps)
        if inps.dtype != torch.float32:
            inps = inps.float()
        return _multiscale_resize(inps, torch.as_tensor(targets),
                                  tuple(self.input_size),
                                  tuple(self._current_size))

    # ---------------- train ----------------

    def _make_loader(self, no_aug):
        loader = self.exp.get_data_loader(
            batch_size=self.args.batch_size,
            is_distributed=self.is_distributed, no_aug=no_aug,
            cache_img=getattr(self.args, "cache", None))
        # batches pinned in the loader's own thread, for the prefetcher's
        # non_blocking copy to the card
        loader.pin_memory = self.device.type == "cuda"
        return loader

    def before_train(self):
        from yolox_tpu_torch.core.train_step import (
            init_train_state,
            make_augmented_train_step,
            make_train_step,
        )
        from yolox_tpu_torch.data import DevicePrefetcher

        logger.info(f"args: {vars(self.args)}")
        logger.info(f"config: {self.exp.name}, device: {self.device}")
        if self.is_distributed:
            logger.info(f"data-parallel over {self.world_size} ranks, "
                        f"{self.args.batch_size // self.world_size} images "
                        "a rank")

        self.module = self.exp.get_model(
            rng_seed=self.exp.seed if self.exp.seed else 0,
            device=self.device)
        logger.info("Model Summary: "
                    + get_model_info(self.module, self.exp.test_size))
        momentum = self.resume_train()
        self.no_aug = (self.start_epoch
                       >= self.max_epoch - self.exp.no_aug_epochs)
        self.use_l1 = self.no_aug

        self.train_loader = self._make_loader(self.no_aug)
        self._device_augment = (bool(self.exp.device_augment)
                                and not self.no_aug)
        self.max_iter = len(self.train_loader.dataset) // \
            self.args.batch_size
        self.lr_scheduler = self.exp.get_lr_scheduler(
            self.exp.basic_lr_per_img * self.args.batch_size, self.max_iter)

        common = dict(
            momentum=self.exp.momentum,
            weight_decay=self.exp.weight_decay,
            use_ema=self.use_model_ema,
            compute_dtype=torch.bfloat16 if self.use_bf16 else torch.float32,
            freeze_prefix=self.exp.freeze_prefix,
            num_candidates=self.exp.resolved_simota_candidates(),
            fused_bwd=bool(self.exp.fused_conv_bwd),
            remat=bool(self.exp.remat),
            group=(torch.distributed.group.WORLD if self.is_distributed
                   else None),
        )
        num_classes = self.exp.num_classes
        self._step = make_train_step(self.module, num_classes, use_l1=False,
                                     **common)
        self._step_l1 = make_train_step(self.module, num_classes,
                                        use_l1=True, **common)
        self._step_aug = None
        if self._device_augment:
            cfg = self.exp
            self._step_aug = make_augmented_train_step(
                self.module, num_classes,
                augment_kwargs=dict(
                    max_labels=120,
                    degrees=float(cfg.degrees),
                    translate=float(cfg.translate),
                    scales=tuple(cfg.mosaic_scale),
                    mixup_scale=tuple(cfg.mixup_scale),
                    shear=float(cfg.shear),
                    enable_mixup=bool(cfg.enable_mixup),
                    flip_prob=float(cfg.flip_prob),
                    hsv_prob=float(cfg.hsv_prob),
                    mosaic_prob=float(cfg.mosaic_prob),
                    mixup_prob=float(cfg.mixup_prob)),
                use_l1=False, **common)
        self._aug_gen = torch.Generator(device=self.device)

        self.train_state = init_train_state(self.module,
                                            use_ema=self.use_model_ema)
        if momentum is not None:
            opt = self.train_state.optimizer
            for name, p in self.module.named_parameters():
                opt.state[p]["momentum_buffer"] = \
                    momentum[name].to(p.device, p.dtype).clone()
        if self.use_model_ema:
            self.train_state.ema.updates = self.max_iter * self.start_epoch

        self.prefetcher = DevicePrefetcher(self.train_loader, self.device)
        self._multiscale_rng = np.random.default_rng(
            (self.exp.seed or 0) + 12345)
        self._current_size = self.input_size

        self.evaluator = self.exp.get_evaluator(
            batch_size=self.args.batch_size,
            is_distributed=self.is_distributed)

        self.tblogger = None
        # rank 0 alone keeps a tracker
        logger_kind = (getattr(self.args, "logger", "tensorboard")
                       if self.rank == 0 else None)
        if logger_kind == "tensorboard":
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                logger.warning("tensorboardX unavailable; scalar logging "
                               "to console only")
            else:
                self.tblogger = SummaryWriter(
                    os.path.join(self.file_name, "tensorboard"))
        elif logger_kind == "mlflow":
            from yolox_tpu_torch.utils.mlflow_logger import MlflowLogger

            self.mlflow_logger = MlflowLogger()
            self.mlflow_logger.setup(args=self.args, exp=self.exp)
        elif logger_kind == "wandb":
            from yolox_tpu_torch.utils.wandb_logger import WandbLogger

            self.wandb_logger = WandbLogger()
            self.wandb_logger.setup(args=self.args, exp=self.exp)

        self.epoch = self.start_epoch  # valid even before the epoch loop
        self._first_step_pending = self.is_distributed
        self._install_preemption_handler()
        logger.info("Training start...")

    def after_train(self):
        self._restore_preemption_handler()
        restore_sys_output()
        logger.info("Training of experiment is done and the best AP is "
                    f"{self.best_ap * 100:.2f}")
        self._stop_profiler()
        if getattr(self, "tblogger", None) is not None:
            self.tblogger.close()
        if getattr(self, "mlflow_logger", None):
            self.mlflow_logger.on_train_end(
                self.args, file_name=self.file_name,
                metadata={"best_ap": round(float(self.best_ap), 5)})
        if getattr(self, "wandb_logger", None):
            self.wandb_logger.finish()
        self.prefetcher = None
        if getattr(self, "train_loader", None) is not None:
            self.train_loader.close()

    def before_epoch(self):
        from yolox_tpu_torch.data import DevicePrefetcher

        logger.info(f"---> start train epoch{self.epoch + 1}")
        if (self.epoch + 1 == self.max_epoch - self.exp.no_aug_epochs
                or self.no_aug):
            logger.info("--->No mosaic aug now!")
            self.prefetcher = None
            if self._device_augment:
                # from the raw-tile loader to the host letterbox loader
                self._device_augment = False
                self.train_loader.close()
                self.train_loader = self._make_loader(no_aug=True)
            else:
                self.train_loader.close_mosaic()
            self.prefetcher = DevicePrefetcher(self.train_loader,
                                               self.device)
            logger.info("--->Add additional L1 loss now!")
            self.use_l1 = True
            self.exp.eval_interval = 1
            if not self.no_aug:
                self.save_ckpt(ckpt_name="last_mosaic_epoch")
                self.no_aug = True

    def after_epoch(self):
        self.save_ckpt(ckpt_name="latest")
        if (self.epoch + 1) % self.exp.eval_interval == 0:
            self.evaluate_and_save_model()

    def before_iter(self):
        self._maybe_profile()

    def after_iter(self):
        if (self.iter + 1) % self.exp.print_interval == 0:
            left_iters = (self.max_iter * self.max_epoch
                          - (self.progress_in_iter + 1))
            eta_seconds = self.meter["iter_time"].global_avg * left_iters
            eta_str = f"ETA: {datetime.timedelta(seconds=int(eta_seconds))}"
            progress_str = (f"epoch: {self.epoch + 1}/{self.max_epoch}, "
                            f"iter: {self.iter + 1}/{self.max_iter}")
            loss_meter = self.meter.get_filtered_meter("loss")
            loss_str = ", ".join(
                [f"{k}: {v.latest:.1f}" for k, v in loss_meter.items()])
            time_meter = self.meter.get_filtered_meter("time")
            time_str = ", ".join(
                [f"{k}: {v.avg:.3f}s" for k, v in time_meter.items()])
            mem_str = (f"dev mem: {device_mem_usage(self.device):.0f}Mb, "
                       f"mem: {mem_usage() / 1024:.1f}Gb")

            logger.info(
                f"{progress_str}, {mem_str}, {time_str}, {loss_str}, "
                f"lr: {self.meter['lr'].latest:.3e}, "
                f"size: {self._current_size[0]:d}, {eta_str}")

            overflow = self.meter.get("cand_overflow")
            if overflow is not None and overflow.avg and overflow.avg > 0:
                logger.warning(
                    "SimOTA candidate compaction overflowed in "
                    f"{overflow.avg:.1%} of recent images (cap "
                    f"simota_candidates="
                    f"{self.exp.resolved_simota_candidates()}): label "
                    "assignment deviates from the reference for those "
                    "images; raise the cap or clear it (None is "
                    "dense-exact)")

            if self.tblogger is not None:
                self.tblogger.add_scalar(
                    "train/lr", self.meter["lr"].latest,
                    self.progress_in_iter)
                for k, v in loss_meter.items():
                    self.tblogger.add_scalar(
                        f"train/{k}", v.latest, self.progress_in_iter)
            if getattr(self, "mlflow_logger", None):
                logs = {"train/" + k: v.latest
                        for k, v in loss_meter.items()}
                logs["train/lr"] = self.meter["lr"].latest
                self.mlflow_logger.on_log(
                    self.args, self.exp, self.epoch + 1, logs)
            if getattr(self, "wandb_logger", None):
                logs = {"train/" + k: v.latest
                        for k, v in loss_meter.items()}
                logs["train/lr"] = self.meter["lr"].latest
                self.wandb_logger.log_metrics(
                    logs, step=self.progress_in_iter)
            self.meter.clear_meters()

        # multiscale: every 10 iterations a new 32-aligned size from the
        # seeded stream (the reference's `config.py:275-294`)
        if not self.exp.deterministic:
            if (self.progress_in_iter + 1) % 10 == 0:
                self._current_size = self.exp.random_resize(
                    self._multiscale_rng)

    @property
    def progress_in_iter(self):
        return self.epoch * self.max_iter + self.iter

    # ------------------------------------------------------------------
    # checkpoints and evaluation
    # ------------------------------------------------------------------

    def resume_train(self):
        """Load `args.resume`'s checkpoint (or `args.ckpt` to fine-tune)
        into the module and set `start_epoch`; returns the resumed SGD
        momentum as a state dict, or None."""
        if getattr(self.args, "resume", False):
            logger.info("resume training")
            ckpt_file = getattr(self.args, "ckpt", None) or os.path.join(
                self.file_name, "latest_ckpt.pth")
            ckpt = load_checkpoint(ckpt_file)
            self.module.load_params(ckpt["model"])
            self.best_ap = ckpt.pop("best_ap", 0)
            start_epoch = getattr(self.args, "start_epoch", None)
            self.start_epoch = (start_epoch - 1 if start_epoch is not None
                                else ckpt["start_epoch"])
            logger.info(f"loaded checkpoint '{ckpt_file}' "
                        f"(epoch {self.start_epoch})")
            if "momentum_buf" in ckpt:
                return state_dict_from_jax(ckpt["momentum_buf"])
            return None
        if getattr(self.args, "ckpt", None) is not None:
            logger.info("loading checkpoint for fine tuning")
            load_ckpt(self.module, load_checkpoint(self.args.ckpt)["model"])
        self.start_epoch = 0
        return None

    def _eval_module(self):
        """The EMA model when training keeps one, else the module."""
        if self.use_model_ema:
            return self.train_state.ema.ema
        return self.module

    def evaluate_and_save_model(self):
        eval_module = self._eval_module()
        with adjust_status(eval_module, training=False):
            results = self.exp.eval(eval_module, self.evaluator,
                                    self.is_distributed,
                                    return_outputs=True)
        (ap50_95, ap50, summary), predictions = results

        update_best_ckpt = ap50_95 > self.best_ap
        self.best_ap = max(self.best_ap, ap50_95)

        if self.tblogger is not None:
            self.tblogger.add_scalar("val/COCOAP50", ap50, self.epoch + 1)
            self.tblogger.add_scalar("val/COCOAP50_95", ap50_95,
                                     self.epoch + 1)
        if getattr(self, "mlflow_logger", None):
            self.mlflow_logger.on_log(
                self.args, self.exp, self.epoch + 1, {
                    "val/COCOAP50": ap50,
                    "val/COCOAP50_95": ap50_95,
                    "val/best_ap": round(self.best_ap, 3),
                })
        if getattr(self, "wandb_logger", None):
            self.wandb_logger.log_metrics({
                "val/COCOAP50": ap50,
                "val/COCOAP50_95": ap50_95,
                "val/best_ap": self.best_ap,
            }, step=self.progress_in_iter)
            self.wandb_logger.log_images(predictions)
        if summary:
            logger.info("\n" + summary)

        self.save_ckpt("last_epoch", update_best_ckpt, ap=ap50_95)
        if self.save_history_ckpt:
            self.save_ckpt(f"epoch_{self.epoch + 1}", ap=ap50_95)

    def save_ckpt(self, ckpt_name, update_best_ckpt=False, ap=None,
                  start_epoch=None):
        """`start_epoch` is the epoch a resume restarts from; the default
        (current epoch + 1) means this epoch completed. The preemption
        path passes the current epoch to redo it. Rank 0 alone writes."""
        if self.rank != 0:
            return
        if start_epoch is None:
            start_epoch = self.epoch + 1
        logger.info(f"Save weights to {self.file_name}")
        opt = self.train_state.optimizer
        buffers = {}
        for name, p in self.module.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            buffers[name] = torch.zeros_like(p) if buf is None else buf
        ckpt_state = {
            "start_epoch": start_epoch,
            "model": self._eval_module().state_dict(),
            # the JAX package's layout, so either package resumes
            "momentum_buf": _tensor_tree(state_dict_to_jax(buffers)),
            "best_ap": float(self.best_ap),
            "curr_ap": None if ap is None else float(ap),
        }
        save_checkpoint(ckpt_state, update_best_ckpt, self.file_name,
                        ckpt_name)
        if getattr(self, "mlflow_logger", None):
            self.mlflow_logger.save_checkpoints(
                self.args, self.exp, self.file_name, self.epoch + 1,
                {"best_ap": self.best_ap, "curr_ap": ap}, update_best_ckpt)
        if getattr(self, "wandb_logger", None):
            self.wandb_logger.save_checkpoint(
                self.file_name, ckpt_name, update_best_ckpt,
                metadata={"epoch": self.epoch + 1, "best_ap": self.best_ap,
                          "curr_ap": ap})


def augment_seed(seed, rank: int, progress: int) -> int:
    """The seed of a rank's device-augmentation generator at an iteration:
    rank 0's is that of a single-process run, and each other rank's is
    offset by rank * 2**40, so the ranks draw independent augmentations
    of their own images."""
    return ((seed or 0) + 777) * 1_000_003 + progress + (rank << 40)


def _tensor_tree(tree):
    """A nested dict of numpy arrays as one of CPU tensors (a checkpoint
    then unpickles with `weights_only`)."""
    return {k: _tensor_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}
