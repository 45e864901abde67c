"""Q1 and Q2: the int8 convolutions of the PTQ serving path
(`csrc/int8_conv.cu`).

The JAX package runs each quantized conv as
`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)` on the
TPU's matrix unit (`yolox_tpu/ops/quant.py:127-135, 230-238`); no Pallas
kernel is replaced, and PyTorch has no int8 convolution on CUDA. Q1 is the
dense conv (groups 1) as an implicit GEMM on the int8 tensor cores
(`mma.sync` m16n8k32, exact int32 sums), Q2 the depthwise conv on the CUDA
cores. Both apply one fused epilogue per output channel c,

    y = act(float(acc) * scale[c] + bias[c])    (SiLU in float64)

and store y as float32 or bfloat16, or requantize it to int8 codes at
`out_scale[c]`. Bound on an H100: operations for the wide 3x3 convs, bytes
for the narrow 1x1 and the depthwise ones (`chip_smoke.int8_conv_bound`).

Codes go in and come out as logical NCHW tensors stored NHWC
(`torch.channels_last`), so concat, upsampling and pooling keep working on
them. `pack_weight` / `pack_dw_weight` lay the int8 OIHW weights out for
the kernels once (`ops/quant.py` caches them per module).

`int8_conv` / `int8_dwconv` launch the kernels for CUDA tensors and run
the plain PyTorch versions, `int8_conv_plain` / `int8_dwconv_plain`, only
for CPU tensors: the same integer conv as `F.conv2d` in float64 on the
codes (exact: |acc| <= 5760 * 127^2 < 2^53), then the same epilogue with
separate torch ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.stem import activate

_ACT_CODES = {"silu": 0, "relu": 1, "lrelu": 2}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}  # 2: int8 at out_scale
K_STEP = 32  # the k depth of one mma.sync m16n8k32


def padded_k(ksize: int, cin: int) -> int:
    """K = ksize^2 cin rounded up to a whole k step."""
    k = ksize * ksize * cin
    return -(-k // K_STEP) * K_STEP


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW (Cout, Cin, k, k) -> Q1's (Cout, Kp): K in the order
    (ky, kx, ci), zeros past K = k^2 Cin."""
    cout, cin, k, _ = wq.shape
    w = wq.permute(0, 2, 3, 1).reshape(cout, k * k * cin)
    return F.pad(w, (0, padded_k(k, cin) - w.shape[1])).contiguous()


def pack_dw_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 depthwise OIHW (C, 1, k, k) -> Q2's (k^2, C)."""
    c, _, k, _ = wq.shape
    return wq.reshape(c, k * k).t().contiguous()


def epilogue_activate(y, act: str):
    """The epilogue's activation on float32 `y`: SiLU in float64 rounded
    once to float32, so that the card and the CPU agree (see the kernel's
    `silu`); relu and lrelu as the blocks compute them."""
    if act == "silu":
        v = y.double()
        return (v / (1 + torch.exp(-v))).float()
    return activate(y, act)


def epilogue_plain(acc, scale, bias, act, out_dtype=torch.float32,
                   out_scale=None):
    """The kernels' epilogue on float64 sums (B, C, H, W): float32 acc
    times scale, plus bias, act, then `out_dtype` or int8 codes at
    `out_scale`; channels_last like the kernels' output."""
    y = acc.float() * scale.view(1, -1, 1, 1)
    y = epilogue_activate(y + bias.view(1, -1, 1, 1), act)
    if out_scale is not None:
        y = torch.round(y / out_scale.view(1, -1, 1, 1)).clamp_(-127, 127)
        out_dtype = torch.int8
    return y.to(out_dtype).contiguous(memory_format=torch.channels_last)


def plain_sums(x, w, ksize: int, stride: int, depthwise: bool = False):
    """The kernels' exact sums as float64 (B, Cout, Ho, Wo): x int8 codes,
    w packed for Q1 (`pack_weight`) or, `depthwise`, for Q2. The
    depthwise sums add the k^2 shifted taps one by one (torch's grouped
    float64 conv on the CPU is ~30x slower than that with many threads);
    every partial sum is an integer below 2^53, so the order is exact."""
    cin = x.shape[1]
    pad = (ksize - 1) // 2
    if not depthwise:
        wt = w[:, :ksize * ksize * cin].reshape(
            w.shape[0], ksize, ksize, cin).permute(0, 3, 1, 2)
        return F.conv2d(x.double(), wt.double(), stride=stride, padding=pad)
    xp = F.pad(x.double(), (pad, pad, pad, pad))
    ho = (x.shape[2] + 2 * pad - ksize) // stride + 1
    wo = (x.shape[3] + 2 * pad - ksize) // stride + 1
    wt = w.double()
    acc = None
    for ky in range(ksize):
        for kx in range(ksize):
            tap = xp[:, :, ky:ky + stride * (ho - 1) + 1:stride,
                     kx:kx + stride * (wo - 1) + 1:stride]
            term = tap * wt[ky * ksize + kx].view(1, cin, 1, 1)
            acc = term if acc is None else acc + term
    return acc


def int8_conv_plain(x, w, scale, bias, ksize: int, stride: int, act: str,
                    out_dtype=torch.float32, out_scale=None):
    """Plain PyTorch version of Q1 (see the module docstring)."""
    return epilogue_plain(plain_sums(x, w, ksize, stride), scale, bias, act,
                          out_dtype, out_scale)


def int8_dwconv_plain(x, w, scale, bias, ksize: int, stride: int, act: str,
                      out_dtype=torch.float32, out_scale=None):
    """Plain PyTorch version of Q2."""
    return epilogue_plain(plain_sums(x, w, ksize, stride, True), scale, bias,
                          act, out_dtype, out_scale)


def _check(what, x, w, wshape, scale, bias, ksize, stride, act, out_dtype,
           out_scale):
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f"{what}: want int8 (B, C, H, W) codes, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if w.dtype != torch.int8 or tuple(w.shape) != wshape \
            or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"{what}: want contiguous int8 weights {wshape} on "
                         f"{x.device}, got {w.dtype} {tuple(w.shape)}")
    if ksize < 1 or stride < 1:
        raise ValueError(f"{what}: bad ksize {ksize} / stride {stride}")
    if act not in _ACT_CODES:
        raise AttributeError(f"Unsupported act type: {act}")
    if out_scale is None and out_dtype not in _OUT_KINDS:
        raise ValueError(f"{what}: output dtype {out_dtype} not supported")
    cout = wshape[0] if what == "Q1" else wshape[1]
    for name, t in (("scale", scale), ("bias", bias),
                    ("out_scale", out_scale)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,) \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"({cout},) on {x.device}")
    pad = (ksize - 1) // 2
    if x.shape[2] + 2 * pad < ksize or x.shape[3] + 2 * pad < ksize:
        raise ValueError(f"{what}: input {tuple(x.shape)} smaller than the "
                         f"{ksize}x{ksize} window")


def _launch(fn, what, x, w, scale, bias, ksize, stride, act, out_dtype,
            out_scale, cout, channels, tail):
    """Allocate the NHWC output and call launcher `fn` with (x, w, scale,
    bias, out_scale, out, kind, B, H, W, *channels, k, stride, act,
    *tail)."""
    b, _, h, wd = x.shape
    pad = (ksize - 1) // 2
    ho = (h + 2 * pad - ksize) // stride + 1
    wo = (wd + 2 * pad - ksize) // stride + 1
    kind = 2 if out_scale is not None else _OUT_KINDS[out_dtype]
    dtype = torch.int8 if out_scale is not None else out_dtype
    out = torch.empty((b, ho, wo, cout), dtype=dtype,
                      device=x.device).permute(0, 3, 1, 2)
    if out.numel() == 0:
        return out
    _build.launch(fn, x.device, what, x.data_ptr(), w.data_ptr(),
                  scale.data_ptr(), bias.data_ptr(),
                  None if out_scale is None else out_scale.data_ptr(),
                  out.data_ptr(), kind, b, h, wd, *channels, ksize, stride,
                  _ACT_CODES[act], *tail)
    return out


def int8_conv(x, w, scale, bias, ksize: int, stride: int, act: str,
              out_dtype=torch.float32, out_scale=None):
    """Q1: dense int8 conv, 'same' padding (ksize - 1) // 2. x (B, Cin, H,
    W) int8 codes (copied to channels_last when not stored so), w
    `pack_weight`'s (Cout, Kp), scale / bias (Cout,) float32. Returns
    (B, Cout, Ho, Wo) channels_last: `out_dtype` (float32 or bfloat16), or
    int8 codes at `out_scale` (Cout,) float32 when given."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, scale, bias, ksize, stride, act,
                               out_dtype, out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"Q1: unsupported device {x.device}")
    cin = x.shape[1] if x.dim() == 4 else 0
    _check("Q1", x, w, (w.shape[0], padded_k(ksize, cin)), scale, bias,
           ksize, stride, act, out_dtype, out_scale)
    if w.data_ptr() % 16:
        raise ValueError("Q1: weights must be 16-byte aligned")
    x = x.contiguous(memory_format=torch.channels_last)
    # 16-byte cp.async rows when each half of a k step lies in one tap
    vec = int(cin % 16 == 0 and x.data_ptr() % 16 == 0)
    out = _launch(_build.load("int8_conv").yolox_int8_conv, "Q1", x, w,
                  scale, bias, ksize, stride, act, out_dtype, out_scale,
                  w.shape[0], (cin, w.shape[0]), (vec,))
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


def int8_dwconv(x, w, scale, bias, ksize: int, stride: int, act: str,
                out_dtype=torch.float32, out_scale=None):
    """Q2: depthwise int8 conv (groups = C), 'same' padding. x (B, C, H,
    W) int8 codes, w `pack_dw_weight`'s (k^2, C); otherwise as
    `int8_conv`."""
    if x.device.type == "cpu":
        return int8_dwconv_plain(x, w, scale, bias, ksize, stride, act,
                                 out_dtype, out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"Q2: unsupported device {x.device}")
    c = x.shape[1] if x.dim() == 4 else 0
    _check("Q2", x, w, (ksize * ksize, c), scale, bias, ksize, stride, act,
           out_dtype, out_scale)
    x = x.contiguous(memory_format=torch.channels_last)
    out = _launch(_build.load("int8_conv").yolox_int8_dwconv, "Q2", x, w,
                  scale, bias, ksize, stride, act, out_dtype, out_scale, c,
                  (c,), ())
    int8_dwconv.launches += 1
    return out


int8_dwconv.launches = 0
