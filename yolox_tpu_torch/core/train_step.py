"""The training step: forward, SimOTA losses, backward, SGD, EMA and BN
statistics, on one device or data-parallel over a process group.

The PyTorch counterpart of the JAX package's `yolox_tpu/core/train_step.py`
(`init_train_state`, `make_train_step`), with the same semantics in
PyTorch idiom: the module trains in place in train mode, BatchNorm layers
update their running statistics in the forward, `torch.optim.SGD`
(nesterov) holds the momentum, and `ModelEMA` the averaged model.

- `group` (a `torch.distributed` process group; JAX's `mesh=`): each rank
  steps on its own share of the global batch. BN normalizes with each
  rank's local batch statistics (nothing is synced in the forward), each
  rank's loss is normalized by its own `num_fg`, and after the backward one
  all-reduce (`parallel/mesh.py::MeanReducer`) takes the mean over the
  ranks of the gradients, of the BN running statistics each rank just
  updated, and of the logged losses, as JAX pmeans its gradients,
  `BNCollector` updates and losses. `num_batches_tracked` is counted once
  on every rank. Every rank then applies the same SGD step and EMA update,
  so parameters, momentum, EMA and statistics stay identical across
  ranks. (torch's `DistributedDataParallel` would copy rank 0's running
  statistics over the others' instead of averaging them.)
- `remat`: the training forward's stages run under activation
  checkpointing (`models/blocks.py::RematStages`), recomputed in the
  backward without moving the running statistics a second time.

- BN: momentum 0.03, unbiased running variance, `num_batches_tracked`
  incremented (`models/blocks.py`).
- `freeze_prefix`: BatchNorm layers whose path starts with it run in eval
  mode (running statistics, no update), and parameters under it keep their
  values and momentum (their gradients are dropped before the SGD step),
  as the reference's `freeze_module` does.
- `compute_dtype` bfloat16: master weights stay float32, each conv casts
  its weight to the activation dtype, BN statistics are float32, and the
  head's outputs are promoted to float32 before the losses.
- `fused_bwd`: every BaseConv runs the fused-backward Function
  (`ops/conv_bwd.py`), whose 1x1 SiLU convs take the kernels K3 and K4.

`make_augmented_train_step` and `make_pipelined_train_step` put the
on-device augmentation (`data/device_augment.py`, whose warp runs the
kernel K5) and the multiscale resize in front of the step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from yolox_tpu_torch.core.optimizer import build_optimizer, set_hyperparams
from yolox_tpu_torch.data.device_augment import device_augment_batch
from yolox_tpu_torch.models.assign import assign_batch, losses_given_assignment
from yolox_tpu_torch.parallel.mesh import MeanReducer
from yolox_tpu_torch.utils.ema import ModelEMA


@dataclass
class TrainState:
    """The module being trained, its optimizer, its EMA and the step count
    (the JAX state's params/stats, momentum, ema/ema_updates, step)."""

    module: torch.nn.Module
    optimizer: torch.optim.SGD
    ema: Optional[ModelEMA]
    step: int = 0


def init_train_state(module, use_ema: bool = True) -> TrainState:
    """Wrap `module` (trained in place) with a fresh three-group SGD (its
    lr, momentum and weight decay are set by each step) and, with
    `use_ema`, a float32 EMA copy."""
    return TrainState(module, build_optimizer(module, lr=0.0),
                      ModelEMA(module) if use_ema else None)


def set_train_mode(module, freeze_prefix: Optional[str] = None) -> None:
    """Train mode, with BatchNorm under `freeze_prefix` in eval mode."""
    module.train()
    if freeze_prefix:
        for name, m in module.named_modules():
            if (isinstance(m, torch.nn.BatchNorm2d)
                    and name.startswith(freeze_prefix)):
                m.eval()


def make_train_step(module, num_classes: int, *, momentum: float = 0.9,
                    weight_decay: float = 5e-4, ema_decay: float = 0.9998,
                    use_ema: bool = True, compute_dtype=torch.float32,
                    use_l1: bool = False, freeze_prefix: Optional[str] = None,
                    num_candidates: Optional[int] = None,
                    fused_bwd: bool = False, remat: bool = False,
                    group=None):
    """Returns step(state, x, labels, lr, assignment=None) -> (state,
    losses).

    x: (B, H, W, 3) float 0-255 pixels, NHWC; labels: (B, M, 5) rows of
    (cls, cx, cy, w, h), zero rows padding; both numpy or tensors, moved to
    the module's device. Under a `group` they are this rank's share of the
    global batch, and the state is the same on every rank. losses:
    total_loss, iou_loss, l1_loss, conf_loss, cls_loss, num_fg,
    cand_overflow as 0-d tensors on the device (their mean over the ranks
    under a group). `assignment`: a SimOTA result
    (`models/assign.py:assign_batch`) to use instead of assigning anew; it
    holds the discrete decisions fixed where two runs are compared.
    """
    reducer = MeanReducer(group) if group is not None else None

    def step(state: TrainState, x, labels, lr, assignment=None):
        if state.module is not module:
            raise ValueError("the state wraps another module than this step")
        if use_ema and state.ema is None:
            raise ValueError("use_ema needs a state made with use_ema=True")
        set_train_mode(module, freeze_prefix)
        dev = next(module.parameters()).device
        x = torch.as_tensor(x).to(dev, compute_dtype)
        labels = torch.as_tensor(labels).to(dev, torch.float32)

        head_out = module.forward_train(x, fused_bwd=fused_bwd, remat=remat)
        if assignment is None:
            assignment = assign_batch(head_out, labels, num_classes,
                                      num_candidates)
        losses = losses_given_assignment(head_out, labels, assignment,
                                         num_classes, use_l1)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        if freeze_prefix:
            for name, p in module.named_parameters():
                if name.startswith(freeze_prefix):
                    p.grad = None  # SGD skips it: value and momentum stay
        losses = {k: v.detach() for k, v in losses.items()}
        if reducer is not None:
            # frozen parameters have no gradient on any rank, and eval-mode
            # BN layers (a frozen prefix) no new statistics
            reducer([p.grad for p in module.parameters()
                     if p.grad is not None]
                    + [t for m in module.modules()
                       if isinstance(m, torch.nn.BatchNorm2d) and m.training
                       for t in (m.running_mean, m.running_var)]
                    + list(losses.values()))
        set_hyperparams(opt, lr=lr, momentum=momentum,
                        weight_decay=weight_decay)
        opt.step()
        state.step += 1
        if use_ema:
            state.ema.update(module, ema_decay)
        return state, losses

    return step


def _make_augment(module, augment_kwargs, step_kwargs):
    """augment(tiles, hw, labels, generator, out_size) -> (imgs, packed):
    `device_augment_batch` on the module's device, its image buffers in
    the step's compute dtype unless `augment_kwargs` says otherwise
    (pixels land there anyway)."""
    aug = dict(augment_kwargs or {})
    aug.setdefault("image_dtype", step_kwargs.get("compute_dtype",
                                                  torch.float32))

    def augment(tiles, hw, labels, generator, out_size):
        dev = next(module.parameters()).device
        return device_augment_batch(
            *(torch.as_tensor(a).to(dev) for a in (tiles, hw, labels)),
            generator, out_size=out_size, **aug)

    return augment


def make_augmented_train_step(module, num_classes: int, *,
                              augment_kwargs: Optional[dict] = None,
                              **step_kwargs):
    """On-device augmentation (+ multiscale resize) followed by the train
    step. Under a `group` (in `step_kwargs`) each rank augments its own
    share of the batch from its own generator.

    Returns step(state, tiles, hw, labels, generator, lr, out_size,
    train_size=None) -> (state, losses), where tiles/hw/labels/generator
    are `device_augment_batch` inputs, moved to the module's device (the
    generator must live there). The augmentation geometry runs at
    `out_size`; when `train_size` differs, the batch is bilinearly resized
    with its labels (`_multiscale_resize`).

    `augment_kwargs`: `device_augment_batch` settings (degrees, translate,
    scales, mixup_scale, shear, enable_mixup, *_prob, max_labels,
    image_dtype); `step_kwargs` go to `make_train_step`.
    """
    augment = _make_augment(module, augment_kwargs, step_kwargs)
    step = make_train_step(module, num_classes, **step_kwargs)

    def step_aug(state, tiles, hw, labels, generator, lr, out_size,
                 train_size=None):
        imgs, packed = augment(tiles, hw, labels, generator, out_size)
        imgs, packed = _multiscale_resize(imgs, packed, out_size, train_size)
        return step(state, imgs, packed, lr)

    return step_aug


def _multiscale_resize(imgs, packed, out_size, train_size):
    """Resize an augmented batch (B, H, W, 3) from `out_size` to the
    multiscale `train_size`, bilinear without antialiasing (half-pixel
    centres, as `jax.image.resize(..., antialias=False)`), and scale the
    packed (cls, cx, cy, w, h) labels to match. No-op when sizes agree."""
    if train_size is None or tuple(train_size) == tuple(out_size):
        return imgs, packed
    imgs = torch.nn.functional.interpolate(
        imgs.permute(0, 3, 1, 2), size=tuple(train_size), mode="bilinear",
        align_corners=False, antialias=False).permute(0, 2, 3, 1)
    sy = train_size[0] / out_size[0]
    sx = train_size[1] / out_size[1]
    packed = packed * torch.tensor([1.0, sx, sy, sx, sy], dtype=packed.dtype,
                                   device=packed.device)
    return imgs, packed


def make_pipelined_train_step(module, num_classes: int, *,
                              augment_kwargs: Optional[dict] = None,
                              **step_kwargs):
    """Augment + step, software-pipelined: each call trains on the batch
    carried from the previous call and augments the next one.

    Returns (prime, step):
      prime(tiles, hw, labels, generator, out_size) -> (imgs, packed)
        augmentation only: the first carried batch;
      step(state, imgs, packed, tiles, hw, labels, generator, lr, out_size,
           train_size=None) -> (state, losses, next_imgs, next_packed)
        resizes the carried batch from out_size to train_size, runs the
        train step on it, then augments the next batch.

    Eager PyTorch has no single program to fuse, so the two run in that
    order on the device's stream, and the trajectory equals the serial
    `make_augmented_train_step`'s. The carried batch always lives at
    `out_size`, so its shape does not change with the multiscale bucket.
    """
    prime = _make_augment(module, augment_kwargs, step_kwargs)
    step = make_train_step(module, num_classes, **step_kwargs)

    def step_pipe(state, imgs, packed, tiles, hw, labels, generator, lr,
                  out_size, train_size=None):
        imgs, packed = _multiscale_resize(imgs, packed, out_size, train_size)
        state, losses = step(state, imgs, packed, lr)
        next_imgs, next_packed = prime(tiles, hw, labels, generator, out_size)
        return state, losses, next_imgs, next_packed

    return prime, step_pipe
