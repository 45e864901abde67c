"""Top-level API, the PyTorch port's counterpart of the JAX package's
`yolox_tpu/models/yolox.py`.

`Yolox` (module + processor) takes images, file paths or HWC uint8 frames
and returns `Detections` dicts; `YoloxModule` is the network, an
`nn.Module` with the upstream state-dict keys. Serving runs on one CUDA
device: the Focus stem and the NMS suppression are the hand-written
kernels K1 and K2, the other convolutions go to cuDNN, and nothing in
`serve` waits for the device until the caller reads the result. In train
mode `forward_train` is the training forward (`core/train_step.py` drives
it); `forward` and `serve` are eval-mode paths.

Entry points place the module on `cuda` unless the caller passes
`device="cpu"`; with no CUDA device and no device asked for they raise.
The package never changes PyTorch's global flags: a caller comparing
float32 results with a reference turns TF32 off itself
(`torch.backends.cudnn.allow_tf32 = False`).
"""

from __future__ import annotations

import itertools
import os
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from yolox_tpu_torch.config import YoloxConfig
from yolox_tpu_torch.models.blocks import BaseConv
from yolox_tpu_torch.models.head import YoloxHead
from yolox_tpu_torch.models.pafpn import YoloPafpn
from yolox_tpu_torch.models.processor import Detections, YoloxProcessor
from yolox_tpu_torch.models.weights import load_pth_state_dict, nested_to_flat
from yolox_tpu_torch.ops.nms import postprocess_fused_levels

_WEIGHTS_URL = (
    "https://github.com/Megvii-BaseDetection/YOLOX/releases/download/"
    "0.1.1rc0/{model_id}.pth"
)
# upstream file-name aliases (`yolox/models/build.py:18-26`)
_WEIGHTS_ALIAS = {"yolov3": "yolox_darknet"}
_DTYPES = (torch.float32, torch.bfloat16)


def yolox_home() -> Path:
    return Path(os.environ.get("YOLOX_HOME",
                               str(Path.home() / ".cache" / "yolox")))


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when none is given; never a silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "yolox_tpu_torch serves on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda")


class Yolox:
    """module + processor wrapper (`yolox.py:22-52`)."""

    def __init__(self, module: "YoloxModule", processor: YoloxProcessor):
        self.module = module
        self.processor = processor

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, config=None,
                        device=None, dtype=torch.float32) -> "Yolox":
        module = YoloxModule.from_pretrained(
            pretrained_model_name_or_path, config, device, dtype=dtype)
        processor = YoloxProcessor(
            config or str(pretrained_model_name_or_path))
        return cls(module, processor)

    @staticmethod
    def _to_image(image):
        """PIL images and HWC uint8 frames pass through; paths are opened
        with Pillow."""
        if isinstance(image, np.ndarray) or hasattr(image, "height"):
            return image
        from PIL import Image

        return Image.open(image)

    def _dispatch(self, images: List, threshold: float):
        """Letterbox + launch one serving batch. The batch is zero-padded
        to the next power of two, so request sizes map onto a few shapes;
        the padded rows are dropped at fetch. Returns (images, dets, valid,
        n) with dets / valid still being computed on the device."""
        batch = self.processor(images, dtype=np.uint8)
        n = len(images)
        padded = 1 << (n - 1).bit_length() if n > 1 else 1
        if padded != n:
            batch = np.concatenate(
                [batch, np.zeros((padded - n,) + batch.shape[1:], batch.dtype)])
        dets, valid = self.module.serve(
            batch, conf_thre=threshold,
            nms_thre=self.processor.config.nmsthre, max_det=1024)
        return images, dets, valid, n

    def _fetch(self, pending) -> List[Detections]:
        images, dets, valid, n = pending
        return self.processor.postprocess_dets(
            images, dets[:n].cpu().numpy(), valid[:n].cpu().numpy())

    def __call__(self, inputs, threshold: float = 0.5) -> List[Detections]:
        if isinstance(inputs, (np.ndarray, torch.Tensor)):
            # a raw batched tensor: decoded predictions out (`yolox.py:42-44`)
            return self.module(inputs)
        images = [self._to_image(image) for image in inputs]
        if self.module.head.decode_in_inference:
            return self._fetch(self._dispatch(images, threshold))
        output = self.module(self.processor(images))
        return self.processor.postprocess(images, output, threshold=threshold)

    def stream(self, inputs: Iterable, threshold: float = 0.5,
               batch_size: int = 16):
        """Pipelined serving over a stream of images: yields one
        `Detections` dict per input, in order, with the same results as
        `__call__` batch by batch. CUDA launches are asynchronous, so batch
        k+1's host work (decode, letterbox, copy to the device) runs while
        the device still computes batch k, whose result is read only once
        batch k+1 is in flight. A ragged last batch is padded like
        `__call__`'s."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        it = iter(inputs)
        if not self.module.head.decode_in_inference:
            while chunk := list(itertools.islice(it, batch_size)):
                yield from self(chunk, threshold=threshold)
            return
        pending = None
        while chunk := list(itertools.islice(it, batch_size)):
            images = [self._to_image(image) for image in chunk]
            dispatched = self._dispatch(images, threshold)
            if pending is not None:
                yield from self._fetch(pending)
            pending = dispatched
        if pending is not None:
            yield from self._fetch(pending)


class YoloxModule(nn.Module):
    """The network: PAFPN backbone + decoupled head. Built in eval mode."""

    def __init__(self, backbone: Optional[YoloPafpn] = None,
                 head: Optional[YoloxHead] = None,
                 config: Optional[YoloxConfig] = None):
        super().__init__()
        self.backbone = backbone if backbone is not None else YoloPafpn()
        self.head = head if head is not None else YoloxHead(80)
        self.config = config
        self.eval()

    # ---------------- construction ----------------

    @classmethod
    def from_config(cls, config: YoloxConfig, rng_seed: int = 0,
                    dtype=torch.float32, device=None) -> "YoloxModule":
        """Build with random weights drawn from `numpy.random.default_rng(
        rng_seed)` in the JAX package's order (the same seed gives the same
        weights), cast to `dtype` and placed on `device`."""
        device = resolve_device(device)
        if type(config).get_model is not YoloxConfig.get_model:
            # configs may define a bespoke model topology (e.g. yolov3)
            module = config.get_model(rng_seed=rng_seed, device=device)
            return module.cast_params(dtype)
        in_channels = [256, 512, 1024]
        backbone = YoloPafpn(config.depth, config.width,
                             in_channels=in_channels,
                             depthwise=config.depthwise, act=config.act)
        head = YoloxHead(config.num_classes, config.width,
                         in_channels=in_channels,
                         depthwise=config.depthwise, act=config.act)
        module = cls(backbone, head, config=config)
        module.init_params(rng_seed)
        return module.cast_params(dtype).to(device)

    def init_params(self, rng_seed: int = 0) -> None:
        rng = np.random.default_rng(rng_seed)
        self.backbone.init_params(rng)
        self.head.init_params(rng)

    def cast_params(self, dtype) -> "YoloxModule":
        """Cast the floating parameters and buffers: float32 (default) or
        bfloat16. Returns self."""
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
        return self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.head.cls_preds[0].weight.dtype

    @property
    def device(self) -> torch.device:
        return self.head.cls_preds[0].weight.device

    # ---------------- forward ----------------

    def _image_batch(self, x) -> torch.Tensor:
        """(B, H, W, 3) or (H, W, 3) image(s), NHWC or NCHW, numpy or
        tensor -> a contiguous NHWC tensor on the module's device: uint8
        stays uint8 (the stem kernel reads it), floats take the module's
        dtype."""
        if self.training:
            raise RuntimeError("forward and serve are eval-mode paths; call "
                               ".eval() first (forward_train trains)")
        x = torch.as_tensor(x)
        if x.dim() == 3:
            x = x[None]
        if x.shape[1] <= 4 and x.shape[3] > 4:  # NCHW -> NHWC
            x = x.permute(0, 2, 3, 1)
        x = x.to(self.device)
        if x.dtype != torch.uint8:
            x = x.to(self.dtype)
        return x.contiguous()

    @torch.inference_mode()
    def forward(self, x):
        """Eval forward: decoded (B, n_anchors, 5 + num_classes) float32."""
        fpn_outs = self.backbone(self._image_batch(x))
        return self.head(fpn_outs).float()

    def forward_train(self, x, fused_bwd: bool = False):
        """Train-mode forward (the JAX package's `apply_train`): x is the
        (B, H, W, 3) float image batch on the module's device, in the
        compute dtype; returns `YoloxHead.forward_train`'s dict. BatchNorm
        layers in train mode update their running statistics. `fused_bwd`
        routes every BaseConv through the fused-backward Function
        (`ops/conv_bwd.py`; its 1x1 SiLU convs take kernels K3 and K4)."""
        if not self.training:
            raise RuntimeError("forward_train needs train mode: call .train()")
        for m in self.modules():
            if isinstance(m, BaseConv):
                m.fused_bwd = fused_bwd
        return self.head.forward_train(self.backbone(x))

    @torch.inference_mode()
    def serve(self, x, conf_thre: float = 0.5, nms_thre: float = 0.65,
              class_agnostic: bool = False, max_det: int = 256):
        """Fused serving step: forward + top-k select + f32 decode of the
        selected candidates + NMS. x: (B, H, W, 3) uint8 or float NHWC.
        Returns (detections (B, max_det, 7), valid (B, max_det)) on the
        module's device, rows (x1, y1, x2, y2, obj, cls_conf, cls_idx)."""
        fpn_outs = self.backbone(self._image_batch(x))
        outs, grids, strides = self.head.forward_raw_levels(fpn_outs)
        return postprocess_fused_levels(
            outs, grids, strides, self.head.num_classes, conf_thre,
            nms_thre, class_agnostic, max_det)

    # ---------------- pretrained loading ----------------

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, config=None,
                        device=None, dtype=torch.float32) -> "YoloxModule":
        path = str(pretrained_model_name_or_path)
        if os.path.isfile(path):
            if config is None:
                raise ValueError(
                    "config must be provided when loading model from a file")
        else:
            config = YoloxConfig.get_named_config(path)
            if config is None:
                raise ValueError(
                    f"Unknown model: {pretrained_model_name_or_path}")
            path = cls._cached_pretrained_weights(path)
        module = cls.from_config(config, dtype=dtype, device=device)
        module.load_params(load_pth_state_dict(path))
        return module

    def load_params(self, state_dict: dict, strict: bool = True) -> None:
        """Install a checkpoint (a flat state dict, or the JAX package's
        nested key layout with OIHW tensors), checking keys and shapes."""
        flat = nested_to_flat(state_dict)
        if strict:
            ref = {k: tuple(v.shape) for k, v in self.state_dict().items()}
            new = {k: tuple(torch.as_tensor(v).shape) for k, v in flat.items()}
            if ref != new:
                missing = sorted(set(ref) - set(new))
                unexpected = sorted(set(new) - set(ref))
                mismatched = sorted(k for k in set(ref) & set(new)
                                    if ref[k] != new[k])
                raise ValueError(
                    "checkpoint/model mismatch: "
                    f"missing={missing[:8]} unexpected={unexpected[:8]} "
                    f"mismatched={mismatched[:8]}")
        self.load_state_dict({k: torch.as_tensor(v) for k, v in flat.items()},
                             strict=strict)

    @classmethod
    def _cached_pretrained_weights(cls, model_id: str) -> str:
        """The upstream checkpoint under `$YOLOX_HOME/weights/`. The port
        never downloads: a missing file raises with the JAX package's
        message."""
        file_id = _WEIGHTS_ALIAS.get(model_id, model_id)
        weights_file = yolox_home() / "weights" / f"{file_id}.pth"
        if not weights_file.exists():
            weights_url = _WEIGHTS_URL.format(model_id=file_id)
            raise RuntimeError(
                f"Could not download pretrained weights for {model_id!r} "
                f"from {weights_url} and none cached at {weights_file}. "
                "In offline environments, place the upstream .pth there "
                "manually.")
        return str(weights_file)
