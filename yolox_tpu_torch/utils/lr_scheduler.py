"""LR schedules, a copy of the JAX package's `yolox_tpu/utils/lr_scheduler.py`
(a re-design of the reference's `yolox/utils/lr_scheduler.py`).

Same schedule family and math: cos, warmcos, yoloxwarmcos (quadratic warmup
from warmup_lr_start, cosine to min_lr_ratio*lr, flat min_lr during the
final no-aug epochs), yoloxsemiwarmcos, multistep. Pure host-side functions
of the iteration counter; the trainer feeds the resulting scalar into the
training step.
"""

from __future__ import annotations

import math
from functools import partial


class LRScheduler:
    def __init__(self, name, lr, iters_per_epoch, total_epochs, **kwargs):
        self.lr = lr
        self.iters_per_epoch = iters_per_epoch
        self.total_epochs = total_epochs
        self.total_iters = iters_per_epoch * total_epochs
        self.__dict__.update(kwargs)
        self.lr_func = self._get_lr_func(name)

    def update_lr(self, iters):
        return self.lr_func(iters)

    def _get_lr_func(self, name):
        if name == "cos":
            return partial(cos_lr, self.lr, self.total_iters)
        if name == "warmcos":
            warmup_total_iters = self.iters_per_epoch * self.warmup_epochs
            warmup_lr_start = getattr(self, "warmup_lr_start", 1e-6)
            return partial(warm_cos_lr, self.lr, self.total_iters,
                           warmup_total_iters, warmup_lr_start)
        if name == "yoloxwarmcos":
            warmup_total_iters = self.iters_per_epoch * self.warmup_epochs
            no_aug_iters = self.iters_per_epoch * self.no_aug_epochs
            warmup_lr_start = getattr(self, "warmup_lr_start", 0)
            min_lr_ratio = getattr(self, "min_lr_ratio", 0.2)
            return partial(yolox_warm_cos_lr, self.lr, min_lr_ratio,
                           self.total_iters, warmup_total_iters,
                           warmup_lr_start, no_aug_iters)
        if name == "yoloxsemiwarmcos":
            warmup_lr_start = getattr(self, "warmup_lr_start", 0)
            min_lr_ratio = getattr(self, "min_lr_ratio", 0.2)
            warmup_total_iters = self.iters_per_epoch * self.warmup_epochs
            no_aug_iters = self.iters_per_epoch * self.no_aug_epochs
            normal_iters = self.iters_per_epoch * self.semi_epoch
            semi_iters = self.iters_per_epoch_semi * (
                self.total_epochs - self.semi_epoch - self.no_aug_epochs)
            return partial(
                yolox_semi_warm_cos_lr, self.lr, min_lr_ratio,
                warmup_lr_start, self.total_iters, normal_iters,
                no_aug_iters, warmup_total_iters, semi_iters,
                self.iters_per_epoch, self.iters_per_epoch_semi)
        if name == "multistep":
            milestones = [
                int(self.total_iters * m / self.total_epochs)
                for m in self.milestones
            ]
            gamma = getattr(self, "gamma", 0.1)
            return partial(multistep_lr, self.lr, milestones, gamma)
        raise ValueError(f"Scheduler version {name} not supported.")


def cos_lr(lr, total_iters, iters):
    return lr * 0.5 * (1.0 + math.cos(math.pi * iters / total_iters))


def warm_cos_lr(lr, total_iters, warmup_total_iters, warmup_lr_start, iters):
    if iters <= warmup_total_iters:
        return ((lr - warmup_lr_start) * iters / float(warmup_total_iters)
                + warmup_lr_start)
    return lr * 0.5 * (1.0 + math.cos(
        math.pi * (iters - warmup_total_iters)
        / (total_iters - warmup_total_iters)))


def yolox_warm_cos_lr(lr, min_lr_ratio, total_iters, warmup_total_iters,
                      warmup_lr_start, no_aug_iter, iters):
    min_lr = lr * min_lr_ratio
    if iters <= warmup_total_iters:
        return ((lr - warmup_lr_start)
                * pow(iters / float(warmup_total_iters), 2)
                + warmup_lr_start)
    if iters >= total_iters - no_aug_iter:
        return min_lr
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
        math.pi * (iters - warmup_total_iters)
        / (total_iters - warmup_total_iters - no_aug_iter)))


def yolox_semi_warm_cos_lr(lr, min_lr_ratio, warmup_lr_start, total_iters,
                           normal_iters, no_aug_iters, warmup_total_iters,
                           semi_iters, iters_per_epoch, iters_per_epoch_semi,
                           iters):
    min_lr = lr * min_lr_ratio
    if iters <= warmup_total_iters:
        return ((lr - warmup_lr_start)
                * pow(iters / float(warmup_total_iters), 2)
                + warmup_lr_start)
    if iters >= normal_iters + semi_iters:
        return min_lr
    if iters <= normal_iters:
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
            math.pi * (iters - warmup_total_iters)
            / (total_iters - warmup_total_iters - no_aug_iters)))
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
        math.pi * (normal_iters - warmup_total_iters
                   + (iters - normal_iters) * iters_per_epoch * 1.0
                   / iters_per_epoch_semi)
        / (total_iters - warmup_total_iters - no_aug_iters)))


def multistep_lr(lr, milestones, gamma, iters):
    for milestone in milestones:
        lr *= gamma if iters >= milestone else 1.0
    return lr
