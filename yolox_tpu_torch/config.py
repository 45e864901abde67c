"""YoloxConfig — hyperparameter dataclass + named model registry.

The same field table, defaults and `-D key=value` coercion as the JAX
package's `yolox_tpu/config.py`, so configs and overrides carry over
unchanged. The port builds the model, the optimizer, the LR scheduler,
the training dataset and loader (host Mosaic/MixUp, or raw tiles for the
on-device augmentation), the evaluation dataset, loader and evaluator, and
the single-process trainer; a data-parallel run raises
`NotImplementedError` until its slice is ported.

Fields that tune the JAX package's TPU layouts (`lane_fold*`,
`serve_lane_fold`, `serve_stem_s2d*`, `train_stem_s2d`, `remat`) are kept
as inert fields so that `-D` overrides stay portable; the port ignores them.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Any, Dict, Literal, Optional, Tuple

import numpy as np


def _later(what: str):
    raise NotImplementedError(
        f"{what} is not ported to yolox_tpu_torch yet (a later slice of the "
        "port brings it; see ROADMAP.md)")


@dataclass
class YoloxConfig:
    name: str

    # ---------------- model config ---------------- #
    num_classes: int = 80
    depth: float = 1.00
    width: float = 1.00
    depthwise: bool = False
    act: Literal["silu", "relu", "lrelu"] = "silu"

    seed: Optional[Any] = None
    output_dir: str = "./out"

    # ---------------- dataloader config ---------------- #
    deterministic: bool = False
    data_num_workers: int = 4
    input_size: Tuple[int, int] = (640, 640)  # (height, width)
    # Actual multiscale ranges: [640 - 5 * 32, 640 + 5 * 32]; 0 disables.
    multiscale_range: int = 5
    random_size: Optional[Tuple[int, int]] = None
    data_dir: Optional[str] = None
    train_ann: str = "instances_train2017.json"
    val_ann: str = "instances_val2017.json"
    test_ann: str = "instances_test2017.json"

    # --------------- transform config ----------------- #
    mosaic_prob: float = 1.0
    mixup_prob: float = 1.0
    hsv_prob: float = 1.0
    flip_prob: float = 0.5
    degrees: float = 10.0
    translate: float = 0.1
    mosaic_scale: Tuple[float, float] = (0.1, 2)
    enable_mixup: bool = True
    mixup_scale: Tuple[float, float] = (0.5, 1.5)
    shear: float = 2.0

    # --------------  training config --------------------- #
    warmup_epochs: int = 5
    max_epoch: int = 300
    warmup_lr: int = 0
    min_lr_ratio: float = 0.05
    basic_lr_per_img: float = 0.01 / 64.0
    scheduler: str = "yoloxwarmcos"
    no_aug_epochs: int = 15
    ema: bool = True
    freeze_prefix: Optional[str] = None
    max_labels: int = 120
    # SimOTA candidate cap; None = dense-exact assignment over all anchors.
    simota_candidates: Optional[int] = None

    weight_decay: float = 5e-4
    momentum: float = 0.9
    print_interval: int = 10
    eval_interval: int = 10
    save_history_ckpt: bool = True
    ckpt_format: str = "pth"
    # TPU-layout knobs of the JAX package; inert in the port.
    remat: bool = False
    lane_fold: bool = True
    lane_fold_target: int = 256
    serve_lane_fold: bool = False
    serve_stem_s2d: Any = "auto"
    serve_stem_s2d_max_batch: int = 32
    train_stem_s2d: bool = False
    # make_train_step's fused_bwd (the fused Conv-BN-act backward, K3/K4)
    fused_conv_bwd: bool = False
    device_augment: bool = False
    warmup_multiscale: bool = False

    # -----------------  testing config ------------------ #
    test_size: Tuple[int, int] = (640, 640)
    test_conf: float = 0.01
    nmsthre: float = 0.65

    dataset: Optional[Any] = None

    @classmethod
    def get_named_config(cls, name: str) -> Optional["YoloxConfig"]:
        factory = _NAMED_CONFIG.get(name.replace("-", "_"))
        return factory() if factory is not None else None

    def validate(self):
        h, w = self.input_size
        if h % 32 or w % 32:
            raise ValueError("input size must be multiples of 32")

    def resolved_simota_candidates(self) -> Optional[int]:
        """The SimOTA compaction cap: an explicit int, or None for
        dense-exact assignment over all anchors."""
        if self.simota_candidates is None:
            return None
        return int(self.simota_candidates)

    def update(self, opts: Dict[str, str]):
        """Apply `-D key=value` CLI overrides with type coercion."""
        for k, v in opts.items():
            if not hasattr(self, k):
                raise AttributeError(
                    f"Unknown model configuration option: {k}")
            src_value = getattr(self, k)
            src_type = type(src_value)

            if isinstance(src_value, (list, tuple)):
                v = v.strip("[]()")
                v = [t.strip() for t in v.split(",")]
                if len(src_value) > 0:
                    src_item_type = type(src_value[0])
                    v = [src_item_type(t) for t in v]
                v = src_type(v)
            elif src_value is not None and src_type != type(v):
                try:
                    v = src_type(v)
                except Exception:
                    v = ast.literal_eval(v)
            elif src_value is None:
                # Optional fields: accept numeric / literal overrides, keep
                # plain strings as strings
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
            if k == "seed":
                v = int(v)
            setattr(self, k, v)

    # ----------------- factory hub ----------------- #

    def get_model(self, rng_seed: int = 0, device=None):
        """Build a fresh YoloxModule with seeded random parameters."""
        from yolox_tpu_torch.models.yolox import YoloxModule

        return YoloxModule.from_config(self, rng_seed=rng_seed, device=device)

    def get_dataset(self, cache: bool = False, cache_type: str = "ram"):
        from yolox_tpu_torch.data import CocoDataset, TrainTransform

        return CocoDataset(
            data_dir=self.data_dir,
            json_file=self.train_ann,
            img_size=self.input_size,
            preproc=TrainTransform(
                max_labels=50,
                flip_prob=self.flip_prob,
                hsv_prob=self.hsv_prob,
            ),
            cache=cache,
            cache_type=cache_type,
        )

    def get_data_loader(self, batch_size, is_distributed=False, no_aug=False,
                        cache_img: Optional[str] = None):
        """The training loader: host Mosaic/MixUp batches, or with
        `device_augment` (and not `no_aug`) raw tiles for the on-device
        augmentation; the no-aug phase letterboxes on the host."""
        from yolox_tpu_torch.data import (
            DataLoader,
            InfiniteSampler,
            MosaicDetection,
            TileDataset,
            TrainTransform,
            YoloBatchSampler,
        )

        if is_distributed:
            _later("data-parallel training (the torch.distributed loader)")
        if self.dataset is None:
            if cache_img is not None:
                raise ValueError("cache_img must be None if you didn't "
                                 "create self.dataset before launch")
            self.dataset = self.get_dataset(cache=False)

        transform = TrainTransform(max_labels=self.max_labels,
                                   flip_prob=self.flip_prob,
                                   hsv_prob=self.hsv_prob)
        if self.device_augment and not no_aug:
            dataset = TileDataset(self.dataset,
                                  tile_size=max(self.input_size))
        elif self.device_augment:
            dataset = MosaicDetection(dataset=self.dataset, mosaic=False,
                                      img_size=self.input_size,
                                      preproc=transform)
        else:
            dataset = MosaicDetection(
                dataset=self.dataset,
                mosaic=not no_aug,
                img_size=self.input_size,
                preproc=transform,
                degrees=self.degrees,
                translate=self.translate,
                mosaic_scale=self.mosaic_scale,
                mixup_scale=self.mixup_scale,
                shear=self.shear,
                enable_mixup=self.enable_mixup,
                mosaic_prob=self.mosaic_prob,
                mixup_prob=self.mixup_prob,
            )
        sampler = InfiniteSampler(len(dataset),
                                  seed=self.seed if self.seed else 0)
        batch_sampler = YoloBatchSampler(sampler=sampler,
                                         batch_size=batch_size,
                                         mosaic=not no_aug)
        return DataLoader(dataset, batch_sampler=batch_sampler,
                          num_workers=self.data_num_workers)

    def random_resize(self, rng: np.random.Generator):
        """Draw a multiscale input size from the 32-aligned bucket set."""
        size_factor = self.input_size[1] * 1.0 / self.input_size[0]
        if self.random_size is None:
            min_size = int(self.input_size[0] / 32) - self.multiscale_range
            max_size = int(self.input_size[0] / 32) + self.multiscale_range
            self.random_size = (min_size, max_size)
        size = int(rng.integers(self.random_size[0], self.random_size[1] + 1))
        return (int(32 * size), 32 * int(size * size_factor))

    def multiscale_sizes(self):
        """The full 32-aligned bucket set `random_resize` draws from."""
        size_factor = self.input_size[1] * 1.0 / self.input_size[0]
        if self.random_size is None:
            min_size = int(self.input_size[0] / 32) - self.multiscale_range
            max_size = int(self.input_size[0] / 32) + self.multiscale_range
        else:
            min_size, max_size = self.random_size
        return [(32 * s, 32 * int(s * size_factor))
                for s in range(int(min_size), int(max_size) + 1)]

    def get_optimizer(self, batch_size, module):
        """Three-group nesterov SGD over `module` (the reference's
        `get_optimizer`; the JAX package returns the settings only)."""
        from yolox_tpu_torch.core.optimizer import build_optimizer

        lr = self.warmup_lr if self.warmup_epochs > 0 \
            else self.basic_lr_per_img * batch_size
        return build_optimizer(module, lr=lr, momentum=self.momentum,
                               weight_decay=self.weight_decay)

    def get_lr_scheduler(self, lr, iters_per_epoch):
        from yolox_tpu_torch.utils.lr_scheduler import LRScheduler

        return LRScheduler(
            self.scheduler,
            lr,
            iters_per_epoch,
            self.max_epoch,
            warmup_epochs=self.warmup_epochs,
            warmup_lr_start=self.warmup_lr,
            no_aug_epochs=self.no_aug_epochs,
            min_lr_ratio=self.min_lr_ratio,
        )

    def get_eval_dataset(self, **kwargs):
        from yolox_tpu_torch.data import CocoDataset, ValTransform

        testdev = kwargs.get("testdev", False)
        legacy = kwargs.get("legacy", False)
        return CocoDataset(
            data_dir=self.data_dir,
            json_file=self.val_ann if not testdev else self.test_ann,
            name="val2017" if not testdev else "test2017",
            img_size=self.test_size,
            preproc=ValTransform(legacy=legacy),
        )

    def get_eval_loader(self, batch_size, is_distributed=False, **kwargs):
        """Sequential batches of `get_eval_dataset` (torch's DataLoader
        with `data_num_workers` workers). Splitting them over processes
        comes with torch.distributed in the trainer (ROADMAP M7)."""
        from yolox_tpu_torch.data import eval_loader
        from yolox_tpu_torch.evaluators.coco_evaluator import (
            require_one_process,
        )

        if is_distributed:
            require_one_process("the evaluation loader")
        return eval_loader(self.get_eval_dataset(**kwargs), batch_size,
                           num_workers=self.data_num_workers)

    def get_evaluator(self, batch_size, is_distributed=False, testdev=False,
                      legacy=False):
        from yolox_tpu_torch.evaluators import CocoEvaluator

        return CocoEvaluator(
            dataloader=self.get_eval_loader(
                batch_size, is_distributed, testdev=testdev, legacy=legacy),
            img_size=self.test_size,
            confthre=self.test_conf,
            nmsthre=self.nmsthre,
            num_classes=self.num_classes,
            testdev=testdev,
        )

    def get_trainer(self, args):
        """The single-process `Trainer` (`args.device`, default cuda)."""
        from yolox_tpu_torch.core.trainer import Trainer

        return Trainer(self, args)

    def eval(self, model, evaluator, is_distributed=False, half=False,
             return_outputs=False):
        """`evaluator.evaluate(model, ...)`: (AP50:95, AP50, summary) for
        a `YoloxModule` on its device."""
        return evaluator.evaluate(
            model, is_distributed, half, return_outputs=return_outputs)


def validate_config(config: YoloxConfig):
    config.validate()


class YoloxS(YoloxConfig):
    def __init__(self):
        super().__init__("yolox_s")
        self.depth = 0.33
        self.width = 0.50


class YoloxM(YoloxConfig):
    def __init__(self):
        super().__init__("yolox_m")
        self.depth = 0.67
        self.width = 0.75


class YoloxL(YoloxConfig):
    def __init__(self):
        super().__init__("yolox_l")
        self.depth = 1.0
        self.width = 1.0


class YoloxX(YoloxConfig):
    def __init__(self):
        super().__init__("yolox_x")
        self.depth = 1.33
        self.width = 1.25


class YoloxTiny(YoloxConfig):
    def __init__(self):
        super().__init__("yolox_tiny")
        self.depth = 0.33
        self.width = 0.375
        self.input_size = (416, 416)
        self.random_size = (10, 20)
        self.mosaic_scale = (0.5, 1.5)
        self.test_size = (416, 416)
        self.enable_mixup = False


class Yolov3(YoloxConfig):
    """Legacy yolov3 variant: Darknet-53 + YoloFpn + decoupled head, lrelu
    (`yolox_tpu/config.py:483-493`); the upstream checkpoint is
    yolox_darknet.pth (`models/yolox.py::_WEIGHTS_ALIAS`)."""

    def __init__(self):
        super().__init__("yolov3")
        self.depth = 1.0
        self.width = 1.0
        self.act = "lrelu"

    def get_model(self, rng_seed: int = 0, device=None):
        """The seeded random yolov3 model on `device` (cuda unless
        given)."""
        from yolox_tpu_torch.models.head import YoloxHead
        from yolox_tpu_torch.models.yolo_fpn import YoloFpn
        from yolox_tpu_torch.models.yolox import YoloxModule, resolve_device

        device = resolve_device(device)
        head = YoloxHead(self.num_classes, self.width,
                         in_channels=(128, 256, 512), act="lrelu")
        module = YoloxModule(YoloFpn(), head, config=self)
        module.init_params(rng_seed)
        return module.to(device)


class YoloxNano(YoloxConfig):
    def __init__(self):
        super().__init__("yolox_nano")
        self.depth = 0.33
        self.width = 0.25
        self.depthwise = True
        self.input_size = (416, 416)
        self.random_size = (10, 20)
        self.mosaic_scale = (0.5, 1.5)
        self.test_size = (416, 416)
        self.mosaic_prob = 0.5
        self.enable_mixup = False


# Registered as factories: a fresh instance per lookup, so a caller that
# mutates its config never changes the registry.
_NAMED_CONFIG = {
    "yolox_s": YoloxS,
    "yolox_m": YoloxM,
    "yolox_l": YoloxL,
    "yolox_x": YoloxX,
    "yolox_tiny": YoloxTiny,
    "yolox_nano": YoloxNano,
    "yolov3": Yolov3,
}
