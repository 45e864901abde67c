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

int8 PTQ serving (`ops/quant.py`): `calibrate_int8` collects the table,
`serve(..., int8_qtab=...)` runs the per-block ladder and
`serve(..., int8_hbm_qtab=...)` the int8-in-HBM mode, their convs on the
int8 kernels Q1 (dense) and Q2 (depthwise); `enable_int8` makes `forward`
run one of them, so the evaluators measure the quantized model.

Serving meshes (`parallel/mesh.py`): `make_serving_fn(mesh=...)`, called
on every rank of a `ServingMesh` with the same global batch, splits the
batch over `data` and the image height over `space` (halo exchanges,
`parallel/halo.py`), gathers each pyramid level's raw map over `space`
before the grids are built and the postprocess (K2) runs on every rank,
then the detections over `data`: every rank returns what `serve` returns
for the whole batch in one process.

Entry points place the module on `cuda` unless the caller passes
`device="cpu"`; with no CUDA device and no device asked for they raise.
The package never changes PyTorch's global flags: a caller comparing
float32 results with a reference turns TF32 off itself
(`torch.backends.cudnn.allow_tf32 = False`).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import urllib.request
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from yolox_tpu_torch.config import YoloxConfig
from yolox_tpu_torch.models.blocks import (
    BaseConv,
    Focus,
    Int8Hooks,
    BlockState,
    RematStages,
)
from yolox_tpu_torch.models.head import YoloxHead
from yolox_tpu_torch.models.pafpn import YoloPafpn
from yolox_tpu_torch.models.processor import Detections, YoloxProcessor
from yolox_tpu_torch.models.weights import load_pth_state_dict, nested_to_flat
from yolox_tpu_torch.ops.nms import postprocess_fused_levels
from yolox_tpu_torch.ops.quant import merge_amax
from yolox_tpu_torch.parallel import halo
from yolox_tpu_torch.parallel.mesh import (
    ServingMesh,
    gather_batch,
    image_sharding,
    process_count,
    space_exchange,
)
from yolox_tpu_torch.utils.h2d import to_device
from yolox_tpu_torch.utils.trace import span

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
        # a `YoloxModule.calibrate_int8` table serves int8 PTQ: `int8_qtab`
        # the per-block ladder, `int8_hbm_qtab` the int8-in-HBM mode
        self.int8_qtab: Optional[dict] = None
        self.int8_hbm_qtab: Optional[dict] = None

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
        with span("yolox.dispatch"):
            batch = self.processor(images, dtype=np.uint8)
            n = len(images)
            padded = 1 << (n - 1).bit_length() if n > 1 else 1
            if padded != n:
                batch = np.concatenate(
                    [batch,
                     np.zeros((padded - n,) + batch.shape[1:], batch.dtype)])
            dets, valid = self.module.serve(
                batch, conf_thre=threshold,
                nms_thre=self.processor.config.nmsthre, max_det=1024,
                int8_qtab=self.int8_qtab, int8_hbm_qtab=self.int8_hbm_qtab)
        return images, dets, valid, n

    def _fetch(self, pending) -> List[Detections]:
        images, dets, valid, n = pending
        with span("yolox.fetch"):
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


class ServingFn(nn.Module):
    """A bound method of a `YoloxModule` with its arguments bound, as an
    `nn.Module` for `torch.export`: `forward(x)` is `body(x, **kwargs)`,
    in inference mode when called eagerly and as it is while
    `torch.export` traces it, so `body` is an undecorated one.
    `make_serving_fn` binds `module.serve_body`; `cli/export.py` also
    binds `module.forward_body` (decoded or raw outputs in a fixed int8
    mode). The module is a submodule, so its parameters are the
    program's."""

    def __init__(self, body, **kwargs):
        super().__init__()
        self.module, self.body, self.kwargs = body.__self__, body, kwargs

    def forward(self, x):
        if torch.compiler.is_exporting():
            return self.body(x, **self.kwargs)
        with torch.inference_mode():
            return self.body(x, **self.kwargs)


class MeshedServingFn(ServingFn):
    """`make_serving_fn(mesh=...)`: `fn(x)` is `serve_meshed(x, mesh,
    ...)`, eager only (its collectives cannot be exported); `stats` has
    the last call's exchanges and gathers (`halo.Transport.stats`)."""

    def __init__(self, body, mesh: ServingMesh, **kwargs):
        super().__init__(body, mesh=mesh, **kwargs)
        self.stats = None

    def forward(self, x):
        if torch.compiler.is_exporting():
            raise RuntimeError(
                "a meshed serving function runs eagerly, its halo exchanges "
                "and gathers between processes: torch.export takes the "
                "one-process make_serving_fn() (no mesh)")
        mesh = self.kwargs["mesh"]
        for t in (mesh.space, mesh.data):
            t.stats = dict.fromkeys(t.stats, 0)
        with torch.inference_mode():
            out = self.body(x, **self.kwargs)
        self.stats = {"space": dict(mesh.space.stats),
                      "data": dict(mesh.data.stats)}
        return out


def _int8_choice(int8_qtab, int8_hbm_qtab):
    """(mode, table) of a serving call's int8 arguments."""
    if int8_hbm_qtab is not None:
        return "hbm", int8_hbm_qtab
    if int8_qtab is not None:
        return "ladder", int8_qtab
    return None, None


def _nhwc(x) -> torch.Tensor:
    """(B, H, W, 3) or (H, W, 3) image(s), NHWC or NCHW, numpy or tensor
    -> an NHWC tensor (a view where it can be)."""
    x = torch.as_tensor(x)
    if x.dim() == 3:
        x = x[None]
    if x.shape[1] <= 4 and x.shape[3] > 4:  # NCHW -> NHWC
        x = x.permute(0, 2, 3, 1)
    return x


class YoloxModule(nn.Module):
    """The network: a PAFPN (or YoloFpn) backbone + decoupled head. Built
    in eval mode."""

    def __init__(self, backbone: Optional[nn.Module] = None,
                 head: Optional[YoloxHead] = None,
                 config: Optional[YoloxConfig] = None):
        super().__init__()
        self.backbone = backbone if backbone is not None else YoloPafpn()
        self.head = head if head is not None else YoloxHead(80)
        self.config = config
        # K1 reads uint8 images; a 3x3 BaseConv stem (Darknet) takes floats
        self._focus_stem = any(isinstance(m, Focus)
                               for m in self.backbone.modules())
        self.block_state = BlockState()
        self._int8_enabled = None  # (mode, table) from enable_int8
        self._meshed = False  # inside a meshed serving call
        for name, m in self.named_modules():
            if isinstance(m, Int8Hooks):
                m.qstate, m.qpath = self.block_state, name
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
        self.drop_caches()
        return self.to(dtype)

    def drop_caches(self) -> None:
        """Forget every block's quantized weights and every BaseConv's
        eval-BN fold (each rebuilt on next use)."""
        for m in self.modules():
            if isinstance(m, Int8Hooks):
                m._q_cache = None
            if isinstance(m, BaseConv):
                m._fold_cache = None

    @property
    def dtype(self) -> torch.dtype:
        return self.head.cls_preds[0].weight.dtype

    @property
    def device(self) -> torch.device:
        return self.head.cls_preds[0].weight.device

    # ---------------- forward ----------------

    def _image_batch(self, x, mode=None) -> torch.Tensor:
        """(B, H, W, 3) or (H, W, 3) image(s), NHWC or NCHW, numpy or
        tensor -> a contiguous NHWC tensor on the module's device: uint8
        stays uint8 where the stem kernel K1 reads it (a Focus stem, in
        float or int8 `mode` "hbm"), everything else takes the module's
        dtype, as the JAX package casts every image. A CPU batch reaches
        a CUDA module by `utils/h2d.to_device` (staged through pinned
        memory above one chunk); the cast follows on the device."""
        if self.training:
            raise RuntimeError("forward and serve are eval-mode paths; call "
                               ".eval() first (forward_train trains)")
        with span("yolox.h2d"):
            x = to_device(_nhwc(x), self.device)
            if x.dtype != torch.uint8 or not self._focus_stem \
                    or mode not in (None, "hbm"):
                x = x.to(self.dtype)
            return x.contiguous()

    @contextlib.contextmanager
    def _int8_mode(self, mode, table=None, percentile=None):
        """Run the blocks in int8 `mode` (None: float) within the block."""
        st = self.block_state
        saved = (st.mode, st.table, st.percentile)
        st.mode, st.table, st.percentile = mode, table, percentile
        try:
            yield st
        finally:
            st.mode, st.table, st.percentile = saved

    @contextlib.contextmanager
    def _meshed_call(self, exchange):
        """The blocks run a meshed call's slab, with `exchange` (None: no
        `space` split), within the block."""
        st = self.block_state
        saved = (self._meshed, st.exchange)
        self._meshed, st.exchange = True, exchange
        try:
            yield
        finally:
            self._meshed, st.exchange = saved

    @torch.inference_mode()
    def forward(self, x):
        """Eval forward: decoded (B, n_anchors, 5 + num_classes) float32;
        int8 after `enable_int8`."""
        mode, table = self._int8_enabled or (None, None)
        return self.forward_body(x, mode, table)

    def forward_body(self, x, mode=None, table=None):
        """`forward` in int8 `mode` (None, "ladder" or "hbm") at `table`,
        without the inference-mode decorator: what `torch.export` traces."""
        with self._int8_mode(mode, table):
            fpn_outs = self.backbone(self._image_batch(x, mode))
            return self.head(fpn_outs).float()

    def forward_train(self, x, fused_bwd: bool = False, remat: bool = False):
        """Train-mode forward (the JAX package's `apply_train`): x is the
        (B, H, W, 3) float image batch on the module's device, in the
        compute dtype; returns `YoloxHead.forward_train`'s dict. BatchNorm
        layers in train mode update their running statistics. `fused_bwd`
        routes every BaseConv through the fused-backward Function
        (`ops/conv_bwd.py`; its 1x1 SiLU convs take kernels K3 and K4).
        `remat` runs the backbone's stages and the neck's CSP layers under
        activation checkpointing (`blocks.RematStages`): the same numbers,
        fewer activations kept for the backward."""
        if not self.training:
            raise RuntimeError("forward_train needs train mode: call .train()")
        for m in self.modules():
            if isinstance(m, BaseConv):
                m.fused_bwd = fused_bwd
            elif isinstance(m, RematStages):
                m.remat = remat
        return self.head.forward_train(self.backbone(x))

    @torch.inference_mode()
    def serve(self, x, conf_thre: float = 0.5, nms_thre: float = 0.65,
              class_agnostic: bool = False, max_det: int = 256,
              int8_qtab: Optional[dict] = None,
              int8_hbm_qtab: Optional[dict] = None):
        """Fused serving step: forward + top-k select + f32 decode of the
        selected candidates + NMS. x: (B, H, W, 3) uint8 or float NHWC.
        Returns (detections (B, max_det, 7), valid (B, max_det)) on the
        module's device, rows (x1, y1, x2, y2, obj, cls_conf, cls_idx).

        `int8_qtab`: a `calibrate_int8` table; every conv+BN+act block runs
        quantize -> int8 conv -> dequant (the per-block ladder).
        `int8_hbm_qtab` (the same kind of table): activations cross blocks
        as int8 codes + per-channel scales, producers requantize in their
        conv's epilogue (the int8-in-HBM mode). Only this call's
        arguments decide the mode, as in the JAX package."""
        return self.serve_body(x, conf_thre, nms_thre, class_agnostic,
                               max_det, int8_qtab, int8_hbm_qtab)

    def serve_body(self, x, conf_thre: float = 0.5, nms_thre: float = 0.65,
                   class_agnostic: bool = False, max_det: int = 256,
                   int8_qtab: Optional[dict] = None,
                   int8_hbm_qtab: Optional[dict] = None):
        """`serve` without the inference-mode decorator: what
        `torch.export` traces (`make_serving_fn`), with no span recorded."""
        mode, table = _int8_choice(int8_qtab, int8_hbm_qtab)
        with span("yolox.serve"):
            with self._int8_mode(mode, table):
                x = self._image_batch(x, mode)
                with span("yolox.backbone"):
                    fpn_outs = self.backbone(x)
                with span("yolox.head"):
                    outs, grids, strides = self.head.forward_raw_levels(
                        fpn_outs)
            with span("yolox.postprocess"):
                return postprocess_fused_levels(
                    outs, grids, strides, self.head.num_classes, conf_thre,
                    nms_thre, class_agnostic, max_det)

    def make_serving_fn(self, mesh=None, conf_thre: float = 0.5,
                        nms_thre: float = 0.65, class_agnostic: bool = False,
                        max_det: int = 256, int8_qtab: Optional[dict] = None,
                        int8_hbm_qtab: Optional[dict] = None) -> "ServingFn":
        """The serving step as an `nn.Module`: `fn(x)` is `serve(x, ...)`
        with the thresholds, `max_det` and int8 tables bound, returning
        (dets, valid). It is what `torch.export.export(fn, (x,))` traces
        (`cli/export.py`); its K1 / K2 / Q1 / Q2 calls become the operators
        of `ops/library.py`. An int8 table's quantized weights are made
        by an eager call, so call `fn` before exporting it, and again
        after changing the parameters in place: the export raises if a
        block's parameters changed since its weights were made.
        With a `ServingMesh` (`parallel/mesh.py`: `data_parallel_mesh`,
        `serving_mesh`), the meshed step (`serve_meshed`): called on every
        rank of the mesh with the same global batch, it returns on every
        rank the (dets, valid) of `serve` on that batch, eagerly only. A
        mesh larger than the process group raises."""
        kwargs = dict(conf_thre=conf_thre, nms_thre=nms_thre,
                      class_agnostic=class_agnostic, max_det=max_det,
                      int8_qtab=int8_qtab, int8_hbm_qtab=int8_hbm_qtab)
        if mesh is None:
            return ServingFn(self.serve_body, **kwargs)
        if not isinstance(mesh, ServingMesh):
            raise TypeError(f"mesh must be a parallel.mesh.ServingMesh "
                            f"(serving_mesh, data_parallel_mesh), not "
                            f"{type(mesh).__name__}")
        if mesh.size > process_count():
            raise ValueError(f"a {mesh.size}-rank serving mesh in a process "
                             f"group of {process_count()}")
        return MeshedServingFn(self.serve_meshed, mesh, **kwargs)

    def serve_meshed(self, x, mesh: ServingMesh, conf_thre: float = 0.5,
                     nms_thre: float = 0.65, class_agnostic: bool = False,
                     max_det: int = 256, int8_qtab: Optional[dict] = None,
                     int8_hbm_qtab: Optional[dict] = None):
        """`serve_body` of the global batch `x` over `mesh`, on this rank's
        images (`data`) and rows (`space`): the backbone and the head run
        on the row slab with halo exchanges, each level's raw map is
        gathered over `space` in row order, the postprocess runs on the
        whole maps, and the detections are gathered over `data`. A rank
        with an empty slab runs no layer and joins the gathers."""
        mode, table = _int8_choice(int8_qtab, int8_hbm_qtab)
        x = _nhwc(x)
        b, h, w, _ = x.shape
        shard = image_sharding(mesh, b, h)
        exchange = space_exchange(mesh, shard)
        if exchange is not None and w % halo.SLAB_STRIDE:
            raise ValueError(f"the image width {w} is not a multiple of "
                             f"{halo.SLAB_STRIDE}")
        r0, r1 = shard.rows
        maps = None
        with span("yolox.serve"):
            with self._int8_mode(mode, table), self._meshed_call(exchange):
                if r1 > r0:
                    x = self._image_batch(x[shard.images, r0:r1], mode)
                    with span("yolox.backbone"):
                        fpn_outs = self.backbone(x)
                    with span("yolox.head"):
                        maps = self.head.raw_level_maps(fpn_outs)
                if exchange is not None:
                    nb = shard.images.stop - shard.images.start
                    shapes = [(nb, 5 + self.head.num_classes, h // s, w // s)
                              for s in self.head.strides]
                    maps = exchange.gather_rows(
                        maps, shapes, self.head.map_dtype(self.dtype, mode),
                        self.device)
            with span("yolox.postprocess"):
                outs, grids, strides = self.head.levels_from_maps(maps)
                dets, valid = postprocess_fused_levels(
                    outs, grids, strides, self.head.num_classes, conf_thre,
                    nms_thre, class_agnostic, max_det)
            return gather_batch(mesh, dets, valid)

    @torch.no_grad()
    def visualize(self, x, targets, save_prefix: str = "assign_vis_"):
        """Draw SimOTA assignment results per image into
        `<save_prefix><b>.png` (the JAX package's `visualize`). x: NHWC
        float batch (BGR pixel values as in training); targets (B, M, 5).
        The assignment needs the train-mode forward, whose BatchNorm
        layers update their running statistics: the module's mode and
        every buffer are put back as they were."""
        from yolox_tpu_torch.models.assign import simota_assign
        from yolox_tpu_torch.utils.visualize import visualize_assign

        was_training = self.training
        saved = {k: v.clone() for k, v in self.named_buffers()}
        try:
            self.train()
            xd = torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                 device=self.device)
            head_out = self.head.forward_train(self.backbone(xd))
        finally:
            for k, v in self.named_buffers():
                v.copy_(saved[k])
            self.train(was_training)
        outputs = head_out["outputs"].float()
        xs, ys = head_out["x_shifts"].float(), head_out["y_shifts"].float()
        strides = head_out["expanded_strides"].float()
        tg = torch.as_tensor(np.asarray(targets), dtype=torch.float32,
                             device=self.device)
        assign = simota_assign(tg, outputs[..., :4], outputs[..., 4],
                               outputs[..., 5:], xs, ys, strides,
                               self.head.num_classes)
        coords = torch.stack([(xs + 0.5) * strides, (ys + 0.5) * strides],
                             1).cpu().numpy()
        fg_all = assign["fg_mask"].cpu().numpy()
        matched_all = assign["matched_gt"].cpu().numpy()
        for b in range(outputs.shape[0]):
            fg = fg_all[b]
            labels = np.asarray(targets[b])
            real = labels[labels.sum(-1) > 0]
            boxes_xyxy = np.stack([
                real[:, 1] - real[:, 3] / 2, real[:, 2] - real[:, 4] / 2,
                real[:, 1] + real[:, 3] / 2, real[:, 2] + real[:, 4] / 2,
            ], 1)
            img = np.asarray(x[b]).astype(np.uint8)
            visualize_assign(img, boxes_xyxy, coords[fg], matched_all[b][fg],
                             f"{save_prefix}{b}.png")

    @torch.inference_mode()
    def calibrate_int8(self, batches, percentile: Optional[float] = None
                       ) -> dict:
        """The int8 activation-scale table over calibration data.

        `batches`: one (B, H, W, 3) array or tensor (NCHW is transposed,
        as in `forward`) or a list of them. Runs the eval forward with a
        calibration sink: each BaseConv records its input's abs-max (or,
        with `percentile`, e.g. 99.99, that percentile of |input|) under
        its module name and its output's per-channel one under
        `<name>.out`, each residual add `<name>.addout`, the Focus stem
        `<stem>.conv` and `<stem>.conv.out`; batches merge by elementwise
        max. Returns {key: float32 tensor} on the module's device, for
        `serve(int8_qtab=...)`, `serve(int8_hbm_qtab=...)` and
        `enable_int8`."""
        if self._meshed:
            raise RuntimeError("calibrate_int8 runs in one process: "
                               "calibrate before the meshed call and hand "
                               "every rank the table")
        if isinstance(batches, (np.ndarray, torch.Tensor)):
            batches = [batches]
        table: dict = {}
        for x in batches:
            x = self._image_batch(x, "calib")
            with self._int8_mode("calib", None, percentile) as st:
                st.sink = {}
                try:
                    self.head.forward_raw_levels(self.backbone(x))
                    new = st.sink
                finally:
                    st.sink = None
            table = merge_amax(table, new)
        return table

    def enable_int8(self, qtab: dict, hbm: bool = False) -> None:
        """From now on `forward` (and so `__call__` and the evaluators'
        inference) runs int8 PTQ at `qtab`: the per-block ladder, or with
        `hbm` the int8-in-HBM mode. The weights are read at call time, so
        a later `load_params` takes effect. Decode stays float32."""
        self._int8_enabled = ("hbm" if hbm else "ladder", qtab)

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
        self.drop_caches()

    @classmethod
    def _cached_pretrained_weights(cls, model_id: str) -> str:
        """The upstream checkpoint under `$YOLOX_HOME/weights/`, fetched
        from the upstream release into `<file>.tmp` and renamed into place
        when it is missing, as the JAX package does; a failed fetch raises
        with the JAX package's message."""
        weights_dir = yolox_home() / "weights"
        weights_dir.mkdir(exist_ok=True, parents=True)
        file_id = _WEIGHTS_ALIAS.get(model_id, model_id)
        weights_file = weights_dir / f"{file_id}.pth"
        if not weights_file.exists():
            weights_url = _WEIGHTS_URL.format(model_id=file_id)
            try:
                urllib.request.urlretrieve(weights_url, f"{weights_file}.tmp")
            except Exception as e:
                raise RuntimeError(
                    f"Could not download pretrained weights for {model_id!r} "
                    f"from {weights_url} and none cached at {weights_file}. "
                    "In offline environments, place the upstream .pth there "
                    "manually."
                ) from e
            os.rename(f"{weights_file}.tmp", weights_file)
        return str(weights_file)
