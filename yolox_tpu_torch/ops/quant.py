"""Post-training int8 quantization for the serving path, the PyTorch
counterpart of the JAX package's `yolox_tpu/ops/quant.py` (same scheme,
same rounding, NCHW layout).

- Weights: eval-mode BatchNorm folded into the conv, then symmetric int8
  per output channel, sw[c] = amax_c / 127.
- Activations: symmetric int8 at a calibrated abs-max,
  xq = clip(round(x / sx), -127, 127), sx = amax / 127 (`jnp.round` and
  `torch.round` both round half to even; both divide).
- The per-block ladder (`conv_bn_act`): every BaseConv quantizes its float
  input, runs the int8 conv and dequantizes in its epilogue; the block
  interface stays float.
- int8-in-HBM (`QTensor`, `conv_bn_act_hbm`): activations cross blocks as
  int8 codes + a per-channel scale; producers requantize in the conv's
  epilogue, consumers fold the incoming scale into their BN-folded
  weights before quantizing them.

The int8 convs are Q1 (dense) and Q2 (depthwise) of `ops/int8_conv.py`,
kernels on CUDA tensors and their plain versions on CPU tensors.
Quantize, dequant, requant, add, concat, pooling and upsampling stay
torch ops, as they were plain XLA ops in JAX; max pooling and nearest
upsampling run on the codes exactly (a max and a copy commute with any
increasing cast).

`prepare_ladder` / `prepare_hbm` do the weight-side work (fold, fold the
input scale, quantize, pack for the kernel) on the host and move the
result to the weights' device, so every device quantizes a checkpoint to
the same int8 weights and scales (a CUDA rsqrt, or a CUDA division by a
Python scalar, which torch turns into a multiplication by its reciprocal,
would round otherwise); the modules cache the result
(`models/blocks.py`), where JAX recomputes it in-trace.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from yolox_tpu_torch.ops.int8_conv import (
    int8_conv,
    int8_dwconv,
    pack_dw_weight,
    pack_weight,
)

INT8_MAX = 127.0
_EPS = 1e-12
BN_EPS = 1e-3


class QTensor(NamedTuple):
    """An int8 activation: codes (B, C, H, W), stored channels_last, and
    the per-channel dequant scale (C,) float32; value = codes * scale."""

    codes: torch.Tensor
    scale: torch.Tensor


class QConv(NamedTuple):
    """A BaseConv's quantized weights as the kernels take them: `w`
    (`pack_weight` / `pack_dw_weight`), the epilogue's float32 `scale`
    and `bias` (C,), the kernel size, the group count, and the ladder's
    input scale `sx` (None in the HBM mode)."""

    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    ksize: int
    groups: int
    sx: Optional[torch.Tensor]


def act_scale(amax, device=None):
    """Per-tensor activation scale sx with a floor against empty ranges,
    computed on the host (an IEEE division) and placed on `device`."""
    a = torch.as_tensor(amax, dtype=torch.float32).cpu()
    return (torch.clamp_min(a, _EPS) / INT8_MAX).to(device)


channel_scale = act_scale  # per-channel: the same formula on a (C,) amax


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def quantize(x, scale):
    """Symmetric int8 quantization of `x` at precomputed `scale`."""
    q = torch.round(x.float() / scale)
    return q.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def fold_bn(w, bn):
    """Fold eval-mode BatchNorm into the OIHW conv weight: (w_fused, bias)
    in float32; `bn` maps weight / bias / running_mean / running_var."""
    gamma, beta = bn["weight"].float(), bn["bias"].float()
    mean, var = bn["running_mean"].float(), bn["running_var"].float()
    a = gamma * torch.rsqrt(var + BN_EPS)
    return w.float() * a.view(-1, 1, 1, 1), beta - mean * a


def weight_qparams(w_fused):
    """Per-output-channel symmetric int8 weights: (wq, sw[c])."""
    amax_c = w_fused.abs().amax(dim=(1, 2, 3))
    sw = torch.clamp_min(amax_c, _EPS) / INT8_MAX
    wq = torch.round(w_fused / sw.view(-1, 1, 1, 1)).clamp_(-INT8_MAX,
                                                              INT8_MAX)
    return wq.to(torch.int8), sw


def _pack(wq, groups: int):
    if groups == 1:
        return pack_weight(wq)
    if wq.shape[1] == 1 and groups == wq.shape[0]:
        return pack_dw_weight(wq)
    raise NotImplementedError(f"grouped conv with groups={groups}")


def _on_host(p):
    """A BaseConv's parameter dict with every tensor on the host."""
    return {"conv": {"weight": p["conv"]["weight"].detach().cpu()},
            "bn": {k: v.detach().cpu() for k, v in p["bn"].items()}}


def _to(qc: QConv, device) -> QConv:
    return qc._replace(w=qc.w.to(device), scale=qc.scale.to(device),
                       bias=qc.bias.to(device),
                       sx=None if qc.sx is None else qc.sx.to(device))


def prepare_ladder(p, amax, groups: int) -> QConv:
    """Ladder-mode weights of a BaseConv (`p`: {"conv": {"weight"}, "bn":
    {...}}) at the calibrated input abs-max: epilogue scale sx * sw.
    Computed on the host, returned on the weights' device."""
    device = p["conv"]["weight"].device
    p = _on_host(p)
    w_fused, bias = fold_bn(p["conv"]["weight"], p["bn"])
    wq, sw = weight_qparams(w_fused)
    sx = act_scale(amax)
    return _to(QConv(_pack(wq, groups), (sx * sw).contiguous(), bias,
                     wq.shape[-1], groups, sx), device)



def fold_in_scale(w_fused, scale, groups: int):
    """Fold a consumer input's per-channel dequant scale into the
    BN-folded float32 OIHW weights: conv(codes * scale, w) ==
    conv(codes, w * scale). groups 1: over the input-channel axis;
    depthwise (groups == C, one input channel a group): over the output
    axis. Other group counts raise."""
    if groups == 1:
        return w_fused * scale.view(1, -1, 1, 1)
    if w_fused.shape[1] == 1 and groups == w_fused.shape[0]:
        return w_fused * scale.view(-1, 1, 1, 1)
    raise NotImplementedError(f"grouped conv with groups={groups}")


def prepare_hbm(p, in_scale, groups: int) -> QConv:
    """HBM-mode weights of a BaseConv whose input has per-channel scale
    `in_scale`: epilogue scale sw. Computed on the host, returned on the
    weights' device."""
    device = p["conv"]["weight"].device
    p = _on_host(p)
    w_fused, bias = fold_bn(p["conv"]["weight"], p["bn"])
    wq, sw = weight_qparams(fold_in_scale(w_fused, in_scale.cpu(), groups))
    return _to(QConv(_pack(wq, groups), sw, bias, wq.shape[-1], groups,
                     None), device)


def conv_int8(xq, qc: QConv, stride: int, act: str,
              out_dtype=torch.float32, out_scale=None):
    """The int8 conv of `qc` on codes `xq`: Q1 (groups 1) or Q2
    (depthwise)."""
    run = int8_conv if qc.groups == 1 else int8_dwconv
    return run(xq, qc.w, qc.scale, qc.bias, qc.ksize, stride, act,
               out_dtype, out_scale)


def conv_bn_act(x, p, amax, stride: int, groups: int, act: str,
                out_dtype=None):
    """Quantized BaseConv body (ladder): quantize x at amax, int8 conv
    with exact int32 sums, acc * (sx * sw) + bias, act, in `out_dtype`
    (default x's)."""
    qc = prepare_ladder(p, amax, groups)
    return conv_int8(quantize(x, qc.sx), qc, stride, act,
                     out_dtype or x.dtype)


def conv_bn_act_hbm(qt: QTensor, p, out_amax, stride: int, groups: int,
                    act: str, requant_out: bool = True):
    """BaseConv body in the int8-in-HBM mode: codes in, int8 conv with the
    input's scale folded into the weights, acc * sw + bias, act, then
    requantized at `out_amax` into a QTensor, or with `requant_out`
    False the float32 activation (a requant deferred to a residual add)."""
    qc = prepare_hbm(p, qt.scale, groups)
    if not requant_out:
        return conv_int8(qt.codes, qc, stride, act)
    s = channel_scale(out_amax, qt.codes.device)
    return QTensor(conv_int8(qt.codes, qc, stride, act, out_scale=s), s)


def merge_amax(tables: Dict[str, torch.Tensor],
               new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Elementwise-max merge of calibration sinks across batches."""
    if not tables:
        return dict(new)
    return {k: torch.maximum(tables[k], v) for k, v in new.items()}


def percentile(a, q: float, channels: bool = False):
    """`jnp.percentile(a, q)` (method 'linear') as JAX's calibration
    computes it in float32: over all of `a`, or per channel (axis 1) of an
    NCHW `a`. Sorts instead of calling `torch.quantile`, which refuses
    more than 2^24 elements. XLA contracts the interpolation
    lo * (1 - w) + hi * w into one fused multiply-add over the rounded
    hi * w; the exact float64 product and one rounding repeat it."""
    a = a.float()
    v = a.transpose(0, 1).reshape(a.shape[1], -1) if channels \
        else a.reshape(1, -1)
    v = torch.sort(v, dim=1).values
    n = v.shape[1]
    pos = torch.tensor(q, dtype=torch.float32) / 100 * (
        torch.tensor(float(n), dtype=torch.float32) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = (1 - hw).item()
    lo = int(low.clamp(0, n - 1))
    hi = int(high.clamp(0, n - 1))
    out = (v[:, lo].double() * lw + (v[:, hi] * hw.to(v.device)).double())
    out = out.float()
    return out if channels else out[0]


def calib_amax(x, q: Optional[float] = None):
    """A BaseConv input's calibration entry: abs-max, or the q-th
    percentile of |x|, as a float32 scalar."""
    ax = x.abs().float()
    return percentile(ax, q) if q is not None else ax.amax()


def calib_channel_amax(y, q: Optional[float] = None):
    """Per-channel abs-max (or percentile) of an NCHW activation."""
    ay = y.abs().float()
    return percentile(ay, q, channels=True) if q is not None \
        else ay.amax(dim=(0, 2, 3))


# -------------------------------------------- int8-in-HBM (QTensor) ops

def requant_at(y, scale) -> QTensor:
    """Float activation -> QTensor at a precomputed per-channel scale."""
    q = torch.round(y.float() / _per_channel(scale))
    return QTensor(q.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8), scale)


def requant(y, amax) -> QTensor:
    """Float activation -> QTensor at the calibrated per-channel amax."""
    return requant_at(y, channel_scale(amax, y.device))


def dequant(qt: QTensor, dtype=torch.float32):
    return qt.codes.to(dtype) * _per_channel(qt.scale.to(dtype))


def q_concat(qts) -> QTensor:
    """Channel concat: codes and scales both concatenated."""
    return QTensor(torch.cat([q.codes for q in qts], dim=1),
                   torch.cat([q.scale for q in qts]))


def q_add(a: QTensor, b: QTensor, out_amax) -> QTensor:
    """Residual add: dequant both, add in float32, requant at out_amax."""
    return requant(dequant(a) + dequant(b), out_amax)


def q_upsample_nearest_2x(qt: QTensor) -> QTensor:
    """Nearest 2x upsampling of the codes as one NHWC broadcast copy (any
    dtype, exact); the output is channels_last."""
    c = qt.codes.permute(0, 2, 3, 1)
    b, h, w, ch = c.shape
    up = c[:, :, None, :, None, :].expand(b, h, 2, w, 2, ch)
    return QTensor(up.reshape(b, 2 * h, 2 * w, ch).permute(0, 3, 1, 2),
                   qt.scale)


def q_max_pool_same(qt: QTensor, ksize: int) -> QTensor:
    """Max pool on the codes: scales are per-channel and positive and the
    pool is spatial, so the max of the codes is the code of the max. Runs
    in float16, which holds every int8 exactly."""
    pooled = F.max_pool2d(qt.codes.half(), ksize, 1, ksize // 2)
    return QTensor(pooled.to(torch.int8), qt.scale)


def pred_conv_hbm(qt: QTensor, weight, bias, compute_dtype=torch.bfloat16):
    """1x1 prediction conv on a QTensor: the input scale folds into the
    float32 weight, then the conv runs in `compute_dtype` (bf16, as the
    JAX package calls it) on the raw codes; un-quantized output."""
    w_eff = (weight.float() * _per_channel(qt.scale)).to(compute_dtype)
    y = F.conv2d(qt.codes.to(compute_dtype), w_eff)
    return y + _per_channel(bias.to(y.dtype))
