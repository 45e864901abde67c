"""Convolutional building blocks as PyTorch modules (NCHW / OIHW).

The PyTorch counterpart of the JAX package's `yolox_tpu/models/blocks.py`.
Module attribute names follow the upstream state-dict keys
(`conv.weight`, `bn.running_mean`, ...), so an upstream `.pth` loads with
`load_state_dict(strict=True)`.

BatchNorm uses eps 1e-3 and momentum 0.03 (the values the pretrained
checkpoints were trained with). In eval mode it normalizes with its running
statistics. In train mode (`BaseConv._forward_train`) it follows the JAX
package's `batch_norm` exactly: two-pass batch mean and biased variance in
f32 (f64 for f64 activations), the running variance updated with the
unbiased estimate, `num_batches_tracked` incremented; a BatchNorm put in
eval mode inside a training module (a frozen prefix) normalizes with its
running statistics and leaves them as they are. Train mode keeps f32
master weights: each conv casts its weight to the activation's dtype.
The running statistics move in the forward, once a step: a stage run
under activation checkpointing (`RematStages.stage`, the port's `remat`)
skips the update when the backward recomputes it, and a data-parallel
step averages the updated statistics over the ranks afterwards
(`core/train_step.py`), as the JAX package pmeans its `BNCollector`
updates.

Every block has an `init_params(rng)` that draws its random weights from a
numpy Generator in the same order and with the same formulas as the JAX
package's `init`, so a seed gives the same weights in both packages.

int8 PTQ serving (`ops/quant.py`): a `YoloxModule` hands its blocks one
`BlockState` (`qstate`) and their module names (`qpath`, the calibration
table's keys). While its mode is set, eval forwards calibrate
("calib": BaseConv input abs-maxes, per-channel `.out` / `.addout`
entries), run the per-block ladder ("ladder") or keep activations int8
between blocks ("hbm"), as the JAX package's `Ctx.calib_sink`,
`int8_qtab` and `int8_hbm_qtab` do.

Serving meshes (`parallel/mesh.py`): the blocks that read neighbouring
rows (a BaseConv of ksize > 1, depthwise ones included; the Focus stem;
SPP's max pools) run their op through `Int8Hooks.spatial`: the op itself
unless a meshed call splits the image height, else the shared state's
`exchange` (`parallel/halo.py::SpaceExchange.spatial`) runs it on the row
slab extended by the neighbours' rows and crops.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from yolox_tpu_torch.ops import conv_bwd
from yolox_tpu_torch.ops import quant
from yolox_tpu_torch.ops.bn_act import bn_act
from yolox_tpu_torch.ops.quant import QTensor
from yolox_tpu_torch.ops.stem import stem_conv_bn_act

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


class SiLU(nn.Module):
    def forward(self, x):
        return F.silu(x)


class LReLU(nn.Module):
    """where(x >= 0, x, 0.1 x), as the JAX package's `lrelu`."""

    def forward(self, x):
        return torch.where(x >= 0, x, 0.1 * x)


_ACTS = {"silu": SiLU, "relu": nn.ReLU, "lrelu": LReLU}


def get_activation(name: str) -> nn.Module:
    if name not in _ACTS:
        raise AttributeError(f"Unsupported act type: {name}")
    return _ACTS[name]()


def init_conv_kernel(rng: np.random.Generator, k: int, cin: int, cout: int,
                     groups: int = 1) -> np.ndarray:
    """torch Conv2d default init (kaiming_uniform_(a=sqrt(5))), drawn in
    the JAX package's HWIO order and returned as OIHW."""
    fan_in = (cin // groups) * k * k
    bound = math.sqrt(1.0 / fan_in)
    w = rng.uniform(-bound, bound, (k, k, cin // groups, cout))
    return w.astype(np.float32).transpose(3, 2, 0, 1)


def init_conv_bias(rng: np.random.Generator, k: int, cin: int, cout: int,
                   groups: int = 1) -> np.ndarray:
    fan_in = (cin // groups) * k * k
    bound = math.sqrt(1.0 / fan_in)
    return rng.uniform(-bound, bound, (cout,)).astype(np.float32)


def _set(param: torch.Tensor, value: np.ndarray) -> None:
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def _reset_bn(bn: nn.BatchNorm2d) -> None:
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
        bn.num_batches_tracked.zero_()


def init_children(rng: np.random.Generator, *mods: nn.Module) -> None:
    for m in mods:
        m.init_params(rng)


def batch_norm_train(z, gamma, beta):
    """Train-mode BN of NCHW `z` with the JAX package's formulas
    (`conv_bwd.batch_stats`), then z * scale + bias with scale and bias
    cast to z's dtype. Returns (y, mean, var)."""
    mean, var, _ = conv_bwd.batch_stats(z)
    return _affine(z, gamma, beta, mean, var), mean, var


def _affine(z, gamma, beta, mean, var):
    inv = torch.rsqrt(var.to(conv_bwd.stat_dtype(z.dtype)) + BN_EPS)
    scale = (gamma * inv).to(z.dtype)
    bias = (beta - mean * gamma * inv).to(z.dtype)
    return z * conv_bwd.per_channel(scale) + conv_bwd.per_channel(bias)


class BlockState:
    """What a YoloxModule's blocks share: the int8 `mode` None (float),
    "calib", "ladder" or "hbm"; the calibration `table`; the calibration
    `sink` and `percentile`; and a meshed serving call's `space` halo
    `exchange` (None outside such a call or without a `space` split).
    Activation scales derived from the table are cached while the same
    table object stays in use."""

    def __init__(self):
        self.exchange = None
        self.mode: Optional[str] = None
        self.table: Optional[dict] = None
        self.sink: Optional[dict] = None
        self.percentile: Optional[float] = None
        self._scales: dict = {}
        self._scales_of = None

    def scale(self, key: str, device) -> torch.Tensor:
        """amax / 127 of table entry `key` on `device` (per-tensor or
        per-channel, as the entry is)."""
        if self._scales_of is not self.table:
            self._scales, self._scales_of = {}, self.table
        s = self._scales.get((key, device))
        if s is None:
            s = self._scales[(key, device)] = quant.act_scale(
                self.table[key], device)
        return s

    def record(self, key: str, x) -> None:
        self.sink[key] = quant.calib_amax(x, self.percentile)

    def record_channels(self, key: str, y) -> None:
        self.sink[key] = quant.calib_channel_amax(y, self.percentile)


def tensors_key(tensors) -> tuple:
    """(address, in-place version, dtype, device) of each tensor: what a
    cache made from them is keyed on, the cache holding the tensors so
    that no other tensor takes their addresses."""
    return tuple((t.data_ptr(), t._version, t.dtype, t.device)
                 for t in tensors)


class Int8Hooks:
    """What a block with int8 hooks carries: the module's `BlockState` and
    its own name there (set by `YoloxModule`), and a cache of its
    quantized weights."""

    qstate: Optional[BlockState] = None
    qpath: str = ""
    _q_cache = None

    def spatial(self, x, ksize, stride, op, axis=2):
        """`op(x)` for an op that reads neighbouring rows; on a meshed
        call's row slab, through its halo exchange."""
        ex = None if self.qstate is None else self.qstate.exchange
        return op(x) if ex is None else ex.spatial(x, ksize, stride, op, axis)

    def int8_mode(self) -> Optional[str]:
        st = self.qstate
        if st is None or st.mode is None:
            return None
        if self.training:
            raise RuntimeError("int8 PTQ is a serving/eval-only path")
        return st.mode

    @staticmethod
    def _cache_key(st, params):
        return (st.mode, id(st.table)) + tensors_key(params)

    def cached(self, params, make):
        """make(), reused while the mode, the table object and every
        tensor of `params` (address, in-place version, dtype) stay the
        same; `YoloxModule.load_params` / `cast_params` also drop it.
        While `torch.export` traces, `params` are fake tensors: the
        weights an eager call made for this mode and table are taken as
        they are (the program keeps them as constants), and there must be
        some, made from the parameters as they are now (the cache keeps
        the real tensors it was made from to check this)."""
        st = self.qstate
        c = self._q_cache
        if torch.compiler.is_exporting():
            if c is None or c[0][:2] != (st.mode, id(st.table)) \
                    or c[1] is not st.table:
                raise RuntimeError(
                    f"{self.qpath}: no quantized weights for this int8 table; "
                    "call the serving function once before exporting it")
            if c[0] != self._cache_key(st, c[3]):
                raise RuntimeError(
                    f"{self.qpath}: the parameters changed since the "
                    "quantized weights were made; call the serving function "
                    "again before exporting it")
            return c[2]
        key = self._cache_key(st, params)
        if c is None or c[0] != key or c[1] is not st.table:
            c = self._q_cache = (key, st.table, make(), tuple(params))
        return c[2]


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean, var, n: int) -> None:
    """torch's train-mode update: momentum 0.03, unbiased running variance."""
    m = BN_MOMENTUM
    unbiased = var * (n / max(n - 1, 1))
    bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
    bn.running_var.copy_((1 - m) * bn.running_var + m * unbiased)
    bn.num_batches_tracked.add_(1)


class BaseConv(Int8Hooks, nn.Module):
    """Conv2d -> BatchNorm -> activation (`network_blocks.py:27-52`).

    In float eval the conv's output takes eval BN and the activation in
    one pass, the epilogue kernel (`ops/bn_act.py`), with BN folded into a
    float32 (scale, bias) that is cached while the BN tensors stay the
    same (`eval_affine`).

    `defer_requant_hbm`: in the HBM mode this conv's float32 output goes
    to a residual add that requantizes (set by Bottleneck / ResLayer)."""

    defer_requant_hbm = False
    # (key, (scale, bias), the BN tensors) of `eval_affine`
    _fold_cache = None
    # set while a checkpointed stage is recomputed in the backward: the
    # running statistics already moved in the forward
    recomputing = False

    def __init__(self, cin, cout, ksize, stride, groups=1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ksize, stride, (ksize - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)
        self.act_name = act
        # train mode: route through the fused-backward Function
        # (`ops/conv_bwd.py`); set by `YoloxModule.forward_train`
        self.fused_bwd = False

    def init_params(self, rng):
        c = self.conv
        _set(c.weight, init_conv_kernel(rng, c.kernel_size[0], c.in_channels,
                                        c.out_channels, c.groups))
        _reset_bn(self.bn)

    def forward(self, x):
        c = self.conv
        if c.kernel_size[0] > 1:
            return self.spatial(x, c.kernel_size[0], c.stride[0],
                                self._forward)
        return self._forward(x)

    def _forward(self, x):
        mode = self.int8_mode()
        if mode is not None:
            return self._forward_int8(x, mode)
        if self.training:
            return self._forward_train(x)
        scale, bias = self.eval_affine()
        return bn_act(self.conv(x), scale, bias, self.act_name)

    def eval_affine(self):
        """`bn_fold()`, reused while the four BN tensors keep their
        address, in-place version, dtype and device (`YoloxModule`'s
        `load_params` and `cast_params` also drop it): the fold is ~5
        small launches. Made anew, not cached, while `torch.export`
        traces (the program computes it), while autograd records (the fold
        stays differentiable, as the epilogue is: `ops/bn_act.py`), and
        for inference tensors (no version)."""
        if torch.compiler.is_exporting() or torch.is_grad_enabled():
            return self.bn_fold()
        bn = self.bn
        tensors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
        try:
            key = tensors_key(tensors)
        except RuntimeError:  # an inference tensor has no version counter
            return self.bn_fold()
        c = self._fold_cache
        if c is None or c[0] != key:
            c = self._fold_cache = (key, self.bn_fold(), tensors)
        return c[1]

    def _qparams(self):
        bn = self.bn
        return {"conv": {"weight": self.conv.weight},
                "bn": {"weight": bn.weight, "bias": bn.bias,
                       "running_mean": bn.running_mean,
                       "running_var": bn.running_var}}

    def _param_tensors(self):
        bn = self.bn
        return (self.conv.weight, bn.weight, bn.bias, bn.running_mean,
                bn.running_var)

    def _forward_int8(self, x, mode):
        st, path = self.qstate, self.qpath
        stride, groups = self.conv.stride[0], self.conv.groups
        if mode == "calib":
            st.record(path, x)
            y = self.act(self.bn(self.conv(x)))
            st.record_channels(f"{path}.out", y)
            return y
        if mode == "ladder":
            qc = self.cached(self._param_tensors(), lambda: quant.prepare_ladder(
                self._qparams(), st.table[path], groups))
            return quant.conv_int8(quant.quantize(x, qc.sx), qc, stride,
                                   self.act_name, x.dtype)
        # hbm: a producer requantizes at its calibrated output amax, unless
        # a residual add after it does
        out_scale = None if self.defer_requant_hbm else st.scale(
            f"{path}.out", self.conv.weight.device)
        if isinstance(x, QTensor):
            qc = self.cached(self._param_tensors(), lambda: quant.prepare_hbm(
                self._qparams(), x.scale, groups))
            y = quant.conv_int8(x.codes, qc, stride, self.act_name,
                                torch.float32, out_scale)
            return y if out_scale is None else QTensor(y, out_scale)
        # an entry conv (a float image in): the float block, then requant
        y = self.act(self.bn(self.conv(x)))
        return y if out_scale is None else quant.requant_at(y, out_scale)

    def _forward_train(self, x):
        c, bn = self.conv, self.bn
        if not bn.training:  # frozen: running statistics, no update
            z = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding,
                         1, c.groups)
            return self.act(_affine(z, bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var))
        if self.fused_bwd:
            y, mean, var = conv_bwd.fused_conv_bn_act(
                x, c.weight, bn.weight, bn.bias, c.stride[0], c.groups,
                self.act_name)
        else:
            z = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding,
                         1, c.groups)
            y, mean, var = batch_norm_train(z, bn.weight, bn.bias)
            y = self.act(y)
        if not self.recomputing:
            update_running_stats(bn, mean, var, y.shape[0] * y.shape[2]
                                 * y.shape[3])
        return y

    def bn_fold(self):
        """Eval-mode BN as float32 (scale, bias): y = conv * scale + bias."""
        bn = self.bn
        inv = torch.rsqrt(bn.running_var.float() + bn.eps)
        scale = bn.weight.float() * inv
        bias = bn.bias.float() - bn.running_mean.float() * scale
        return scale, bias


@contextlib.contextmanager
def recomputing(module: nn.Module):
    """The BaseConvs under `module` skip their running-statistic update
    while this is open."""
    convs = [m for m in module.modules() if isinstance(m, BaseConv)]
    for m in convs:
        m.recomputing = True
    try:
        yield
    finally:
        for m in convs:
            m.recomputing = False


class RematStages:
    """A network whose stages may run under activation checkpointing (the
    JAX package's `remat`, `jax.checkpoint` around the training forward).
    With `remat` set (`YoloxModule.forward_train` sets it) and gradients
    on, `stage(block, x)` keeps only the stage's input and output and the
    backward recomputes the rest, its BN running statistics left as the
    forward moved them; otherwise it is `block(x)`. The arithmetic is the
    same either way: only which activations live until the backward
    differs. Checkpointing stage by stage, not the whole forward at once,
    is what lowers the peak: the backward recomputes one stage at a
    time."""

    remat = False

    def stage(self, block: nn.Module, x):
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(x)
        return checkpoint(block, x, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), recomputing(block)))


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (`network_blocks.py:55-74`)."""

    def __init__(self, cin, cout, ksize, stride=1, act="silu"):
        super().__init__()
        self.dconv = BaseConv(cin, cin, ksize, stride, groups=cin, act=act)
        self.pconv = BaseConv(cin, cout, 1, 1, groups=1, act=act)

    def init_params(self, rng):
        init_children(rng, self.dconv, self.pconv)

    def forward(self, x):
        return self.pconv(self.dconv(x))


def _residual(block, y, x):
    """y + x for a residual block; in the HBM mode y is the deferred
    float32 output and x a QTensor, requantized together at the block's
    `.addout` amax; calibration records that amax."""
    mode = block.int8_mode()
    if mode == "hbm":
        st = block.qstate
        return quant.requant_at(y + quant.dequant(x), st.scale(
            f"{block.qpath}.addout", y.device))
    out = x + y
    if mode == "calib":
        block.qstate.record_channels(f"{block.qpath}.addout", out)
    return out


class Bottleneck(Int8Hooks, nn.Module):
    """Standard bottleneck (`network_blocks.py:77-99`)."""

    def __init__(self, cin, cout, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu"):
        super().__init__()
        hidden = int(cout * expansion)
        Conv = DWConv if depthwise else BaseConv
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv2 = Conv(hidden, cout, 3, stride=1, act=act)
        self.use_add = shortcut and cin == cout
        if self.use_add:
            (self.conv2.pconv if depthwise else self.conv2
             ).defer_requant_hbm = True

    def init_params(self, rng):
        init_children(rng, self.conv1, self.conv2)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return _residual(self, y, x) if self.use_add else y


class ResLayer(Int8Hooks, nn.Module):
    """YOLOv3 residual layer (`network_blocks.py:102-117`)."""

    def __init__(self, cin: int):
        super().__init__()
        mid = cin // 2
        self.layer1 = BaseConv(cin, mid, 1, 1, act="lrelu")
        self.layer2 = BaseConv(mid, cin, 3, 1, act="lrelu")
        self.layer2.defer_requant_hbm = True

    def init_params(self, rng):
        init_children(rng, self.layer1, self.layer2)

    def forward(self, x):
        return _residual(self, self.layer2(self.layer1(x)), x)


class SPPBottleneck(Int8Hooks, nn.Module):
    """Spatial pyramid pooling, kernels (5, 9, 13) (`network_blocks.py:120-142`)."""

    def __init__(self, cin, cout, kernel_sizes=(5, 9, 13), activation="silu"):
        super().__init__()
        hidden = cin // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=activation)
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), cout, 1, 1,
                              act=activation)

    def init_params(self, rng):
        init_children(rng, self.conv1, self.conv2)

    def forward(self, x):
        x = self.conv1(x)
        hbm = self.int8_mode() == "hbm"  # pool the codes, concat codes+scales
        pool = quant.q_max_pool_same if hbm else max_pool_same
        pools = self.spatial(x, max(self.kernel_sizes), 1,
                             lambda t: [pool(t, k) for k in self.kernel_sizes])
        if hbm:
            return self.conv2(quant.q_concat([x] + pools))
        return self.conv2(torch.cat([x] + pools, dim=1))


class CspLayer(Int8Hooks, nn.Module):
    """C3: CSP bottleneck with 3 convs (`network_blocks.py:145-183`)."""

    def __init__(self, cin, cout, n=1, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu"):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv2 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv3 = BaseConv(2 * hidden, cout, 1, 1, act=act)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act)
            for _ in range(n)])

    def init_params(self, rng):
        init_children(rng, self.conv1, self.conv2, self.conv3, *self.m)

    def forward(self, x):
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(cat(self, [x1, x2]))


def fold_focus_weight(w: torch.Tensor) -> torch.Tensor:
    """Focus conv weight (C, 12, k, k) -> the equivalent (C, 3, 2k, 2k)
    kernel of one stride-2 conv on the raw image.

    Input-channel groups of the checkpoint weight are the Focus quadrants in
    the order TL, BL, TR, BR, i.e. (dy, dx) = (0,0), (1,0), (0,1), (1,1):
    wb[o, c, dy + 2u, dx + 2v] = w[o, g * 3 + c, u, v]
    (the JAX package's `Focus._space_to_depth_kernel`).
    """
    cout, c4, k, _ = w.shape
    cin = c4 // 4
    wb = w.new_zeros((cout, cin, 2 * k, 2 * k))
    for g, (dy, dx) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        wb[:, :, dy::2, dx::2] = w[:, g * cin:(g + 1) * cin]
    return wb


class Focus(Int8Hooks, nn.Module):
    """Space-to-depth 2x2 then conv (`network_blocks.py:186-208`).

    Takes the NHWC image (B, H, W, 3) and returns the NCHW activation
    (B, C, H/2, W/2). In eval mode it runs as the fused stem kernel K1
    (`yolox_tpu_torch/ops/stem.py`) on a uint8 or float image, in the
    module's dtype: the k x k conv on the space-to-depth image is one
    2k x 2k stride-2 conv on the raw image with the folded kernel. K1 folds
    the running statistics and has no gradient, so train mode runs the
    plain differentiable path instead: space-to-depth in the quadrant
    order TL, BL, TR, BR, then the BaseConv with batch statistics, on a
    float image. The checkpoint layout is untouched.

    int8: the ladder quantizes the image and runs the folded 6x6 stride-2
    conv through Q1 (K1 does not run); the HBM mode keeps the stem float
    (K1) and requantizes its output. Table keys: `<path>.conv` (the
    image's abs-max) and `<path>.conv.out`.
    """

    def __init__(self, cin, cout, ksize=1, stride=1, act="silu"):
        super().__init__()
        if stride != 1:
            raise ValueError("Focus always uses stride 1")
        self.act_name = act
        self.conv = BaseConv(cin * 4, cout, ksize, stride, act=act)

    def init_params(self, rng):
        self.conv.init_params(rng)

    def forward(self, x):
        if self.training:
            x = x.permute(0, 3, 1, 2)
            return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                        x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                       dim=1))
        # the folded 2k x 2k stride-2 conv on the NHWC image's rows
        return self.spatial(x, 2 * self.conv.conv.kernel_size[0], 2,
                            self._forward_eval, axis=1)

    def _forward_eval(self, x):
        mode = self.int8_mode()
        if mode == "ladder":
            return self._forward_ladder(x)
        if mode == "calib":
            self.qstate.record(f"{self.qpath}.conv", x)
        scale, bias = self.conv.bn_fold()
        wb = fold_focus_weight(self.conv.conv.weight.float()).contiguous()
        y = stem_conv_bn_act(x, wb, scale, bias, self.act_name,
                             out_dtype=self.conv.conv.weight.dtype)
        if mode == "calib":
            self.qstate.record_channels(f"{self.qpath}.conv.out", y)
        elif mode == "hbm":  # the stem stays float; its output goes int8
            q = quant.requant_at(y, self.qstate.scale(
                f"{self.qpath}.conv.out", y.device))
            return QTensor(q.codes.contiguous(
                memory_format=torch.channels_last), q.scale)
        return y

    def _forward_ladder(self, x):
        """The folded 2k x 2k stride-2 stem conv quantized like any
        BaseConv ((2k - 1) // 2 == k - 1: the same padding) on the
        quantized (B, H, W, 3) image."""
        c = self.conv

        def make():
            p = c._qparams()
            p["conv"] = {"weight": fold_focus_weight(c.conv.weight.float())}
            return quant.prepare_ladder(p, self.qstate.table[
                f"{self.qpath}.conv"], 1)

        qc = self.cached(c._param_tensors(), make)
        xq = quant.quantize(x, qc.sx).permute(0, 3, 1, 2)
        return quant.conv_int8(xq, qc, 2, self.act_name, x.dtype)


def cat(block, xs):
    """Channel concat of float activations, or of QTensors in a block
    running the HBM mode."""
    if block.int8_mode() == "hbm":
        return quant.q_concat(xs)
    return torch.cat(xs, dim=1)


def upsample(block, x):
    """Nearest 2x upsampling of a float activation, or of a QTensor in a
    block running the HBM mode."""
    if block.int8_mode() == "hbm":
        return quant.q_upsample_nearest_2x(x)
    return upsample_nearest_2x(x)


def max_pool_same(x, ksize: int):
    """MaxPool2d(kernel_size=k, stride=1, padding=k//2)."""
    return F.max_pool2d(x, ksize, 1, ksize // 2)


def upsample_nearest_2x(x):
    """nn.Upsample(scale_factor=2, mode='nearest') over NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
