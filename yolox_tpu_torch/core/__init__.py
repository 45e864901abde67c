"""Training core: the train step (plain, augmented and pipelined), the
optimizer and the single-process trainer."""

from yolox_tpu_torch.core.optimizer import build_optimizer
from yolox_tpu_torch.core.train_step import (
    TrainState,
    init_train_state,
    make_augmented_train_step,
    make_pipelined_train_step,
    make_train_step,
)
from yolox_tpu_torch.core.trainer import PreemptionExit, Trainer

__all__ = ["PreemptionExit", "TrainState", "Trainer", "build_optimizer",
           "init_train_state", "make_augmented_train_step",
           "make_pipelined_train_step", "make_train_step"]
