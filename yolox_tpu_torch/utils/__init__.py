"""Training utilities: checkpoints, logging, meters, model EMA, LR
schedules, model utilities and the environment setup."""

from yolox_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_ckpt,
    save_checkpoint,
)
from yolox_tpu_torch.utils.ema import ModelEMA
from yolox_tpu_torch.utils.logger import logger, setup_logger
from yolox_tpu_torch.utils.lr_scheduler import LRScheduler
from yolox_tpu_torch.utils.metric import AverageMeter, MeterBuffer
from yolox_tpu_torch.utils.model_utils import (
    adjust_status,
    count_params,
    freeze_mask,
    fuse_model,
    get_model_info,
)

__all__ = [
    "load_checkpoint",
    "load_ckpt",
    "save_checkpoint",
    "ModelEMA",
    "logger",
    "setup_logger",
    "LRScheduler",
    "AverageMeter",
    "MeterBuffer",
    "adjust_status",
    "count_params",
    "freeze_mask",
    "fuse_model",
    "get_model_info",
]
