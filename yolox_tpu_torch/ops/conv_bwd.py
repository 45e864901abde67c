"""Conv -> train-mode BN -> activation with a fused backward, and the
kernels K3 and K4 of its 1x1 case (`csrc/conv_bwd.cu`).

The PyTorch counterpart of the JAX package's `fused_conv_bn_act`
(`yolox_tpu/ops/pallas_conv_bwd.py`), a `torch.autograd.Function`:

- **Forward**: the conv, then two-pass f32 batch mean and variance (f64
  for f64 inputs), then y = act(z_hat * gamma + beta). Returns
  (y, mean, var) and saves (x, w, gamma, beta, z, mean, inv).
- **Backward**, every shape: with z_hat = (z - mean) * inv,
  g_a = g_y * act'(gamma * z_hat + beta), S1 = sum g_a, S2 = sum g_a z_hat,

      g_z = gamma * inv * (g_a - S1/N - z_hat * S2/N),  g_gamma = S2,
      g_beta = S1,

  g_z is rounded to the activation dtype and the conv's dgrad and wgrad
  go to cuDNN (XLA's in the JAX package).
- **The 1x1, stride-1, groups-1 SiLU case** runs the sums as K3
  (`reduce_sums`, replaces `pallas_conv_bwd.py::_reduce_kernel`) and g_z
  with both products as K4 (`main_1x1`, replaces `_main_kernel_1x1`):
  g_z never reaches device memory.

The (mean, var) outputs feed the running-statistic update only; nothing
differentiable depends on them, so their cotangents are ignored, as in
JAX.

Layout: the port's NCHW. Per image b of a 1x1 conv, X_b is (Ci, HW) and
g_z,b is (Co, HW): g_x,b = W^T g_z,b and g_W = sum_b g_z,b X_b^T, W being
the (Co, Ci) OIHW weight. The kernels read each tensor in place when every
image's (C, H, W) block is contiguous (a batch stride of any size, as a
channel slice of a concatenation's gradient has), and a copy is made
only otherwise.

`reduce_sums` and `main_1x1` launch the kernels for CUDA tensors and run
their plain versions, `reduce_sums_plain` and `main_1x1_plain`, only for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.stem import activate

BN_EPS = 1e-3
ACTS = ("silu", "lrelu", "relu")
_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
# row-range splits: aim for this many blocks (132 SMs) in K3's streaming
# reduction and in K4's split-K wgrad
_K3_BLOCKS = 2112
_K4_BLOCKS = 528
_TILE = 64


def act_grad(name, a):
    """d act(a) / da."""
    if name == "silu":
        s = torch.sigmoid(a)
        return s * (1.0 + a * (1.0 - s))
    one = torch.ones_like(a)
    return torch.where(a >= 0, one, one * (0.1 if name == "lrelu" else 0.0))


def uses_kernels(ksize, stride, groups, act) -> bool:
    """The 1x1 stride-1 groups-1 SiLU convs take K3 and K4."""
    return ksize == 1 and stride == 1 and groups == 1 and act == "silu"


def stat_dtype(dtype):
    """BN statistics run in f32 for f32 / bf16 activations, f64 for f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def per_channel(v):
    """(C,) -> (1, C, 1, 1), to broadcast over NCHW."""
    return v[None, :, None, None]


def batch_stats(z):
    """Train-mode BN statistics of NCHW `z`, the JAX package's two-pass
    formulas: (mean, biased var, z - mean) in `stat_dtype`."""
    sdt = stat_dtype(z.dtype)
    mean = z.mean((0, 2, 3), dtype=sdt)
    diff = z.to(sdt) - per_channel(mean)
    return mean, (diff * diff).mean((0, 2, 3)), diff


# ---------------------------------------------------------------------------
# K3: per-channel S1 = sum g_a, S2 = sum g_a * z_hat
# ---------------------------------------------------------------------------

def reduce_sums_plain(z, g_y, gamma, beta, mean, inv):
    """Plain version of K3. z, g_y (B, C, H, W); gamma, beta, mean, inv
    (C,). Returns (2, C): S1 and S2, in f32 (f64 for f64 inputs)."""
    sdt = stat_dtype(z.dtype)
    zh = (z.to(sdt) - per_channel(mean.to(sdt))) * per_channel(inv.to(sdt))
    ga = g_y.to(sdt) * act_grad("silu", zh * per_channel(gamma.to(sdt))
                                 + per_channel(beta.to(sdt)))
    return torch.stack([ga.sum((0, 2, 3)), (ga * zh).sum((0, 2, 3))])


def _nchw_view(t):
    """t itself when each image's (C, H, W) block is contiguous (any batch
    stride), else a contiguous copy. Returns (tensor, batch stride)."""
    b, c, h, w = t.shape
    if not (t.stride(3) == 1 and t.stride(2) == w and t.stride(1) == h * w
            and (b == 1 or t.stride(0) >= c * h * w)):
        t = t.contiguous()
    return t, (t.stride(0) if b > 1 else c * h * w)


def _check_cuda(name, tensors, dtype):
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported (float32, "
                         "bfloat16)")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: mixed dtypes {t.dtype} and {dtype}")


def _splits(tiles, rows, min_rows, blocks):
    """Number of row ranges to split a reduction over, so that about
    `blocks` blocks run and each range has >= min_rows rows."""
    return max(1, min(-(-blocks // tiles), rows // min_rows))


def reduce_sums(z, g_y, gamma, beta, mean, inv):
    """K3: (2, C) float32 S1, S2 (see `reduce_sums_plain`)."""
    if z.device.type == "cpu":
        return reduce_sums_plain(z, g_y, gamma, beta, mean, inv)
    if z.device.type != "cuda":
        raise ValueError(f"reduce_sums: unsupported device {z.device}")
    _check_cuda("reduce_sums", (z, g_y), z.dtype)
    if z.shape != g_y.shape or z.dim() != 4:
        raise ValueError(f"reduce_sums: z {tuple(z.shape)} and g_y "
                         f"{tuple(g_y.shape)} must be one (B, C, H, W) shape")
    b, c, h, w = z.shape
    gb = torch.stack([gamma, beta, mean, inv]).to(torch.float32).contiguous()
    if gb.shape != (4, c) or gb.device != z.device:
        raise ValueError("reduce_sums: gamma, beta, mean, inv must be (C,) "
                         f"on {z.device}")
    z, sz = _nchw_view(z)
    g_y, sg = _nchw_view(g_y)
    rows = b * h * w
    splits = _splits(c, rows, 1024, _K3_BLOCKS)
    partial = torch.empty((splits, 2, c), dtype=torch.float32, device=z.device)
    out = torch.empty((2, c), dtype=torch.float32, device=z.device)
    fn = _build.load("conv_bwd").yolox_bn_silu_reduce
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), sz, g_y.data_ptr(), sg, _DTYPE_CODES[z.dtype],
                 gb.data_ptr(), partial.data_ptr(), out.data_ptr(), b, c,
                 h * w, splits, stream)
    _build.check(err, "reduce_sums kernel")
    reduce_sums.launches += 1
    return out


reduce_sums.launches = 0


# ---------------------------------------------------------------------------
# K4 (1x1): g_z in registers -> dgrad g_x = W^T g_z, wgrad g_W = g_z X^T
# ---------------------------------------------------------------------------

def main_1x1_plain(x, z, g_y, w, coeff):
    """Plain version of K4. x (B, Ci, H, W); z, g_y (B, Co, H, W); w
    (Co, Ci) in x's dtype; coeff (7, Co) rows gamma, beta, gamma * inv,
    S1/N, S2/N, mean, inv. g_z is rounded to x's dtype before both
    products, which accumulate in f32 (f64 for f64 inputs). Returns g_x
    (B, Ci, H, W) in x's dtype and g_W (Co, Ci) f32 (f64)."""
    sdt = stat_dtype(z.dtype)
    gamma, beta, ginv, s1n, s2n, mean, inv = (per_channel(r)
                                              for r in coeff.to(sdt))
    zh = (z.to(sdt) - mean) * inv
    ga = g_y.to(sdt) * act_grad("silu", zh * gamma + beta)
    g_z = (ginv * (ga - s1n - zh * s2n)).to(x.dtype).to(sdt)
    g_x = torch.einsum("oi,bohw->bihw", w.to(sdt), g_z).to(x.dtype)
    g_w = torch.einsum("bohw,bihw->oi", g_z, x.to(sdt))
    return g_x, g_w


def main_1x1(x, z, g_y, w, coeff):
    """K4: (g_x, g_W) (see `main_1x1_plain`)."""
    if x.device.type == "cpu":
        return main_1x1_plain(x, z, g_y, w, coeff)
    if x.device.type != "cuda":
        raise ValueError(f"main_1x1: unsupported device {x.device}")
    _check_cuda("main_1x1", (x, z, g_y, w), x.dtype)
    b, ci, h, wd = x.shape
    co = z.shape[1]
    if (z.shape != (b, co, h, wd) or g_y.shape != z.shape
            or w.shape != (co, ci)):
        raise ValueError(
            f"main_1x1: shapes x {tuple(x.shape)}, z {tuple(z.shape)}, g_y "
            f"{tuple(g_y.shape)}, w {tuple(w.shape)} do not form a 1x1 conv")
    coeff = coeff.to(torch.float32).contiguous()
    if coeff.shape != (7, co) or coeff.device != x.device:
        raise ValueError(f"main_1x1: coeff must be (7, Co) on {x.device}")
    x, sx = _nchw_view(x)
    z, sz = _nchw_view(z)
    g_y, sg = _nchw_view(g_y)
    w = w.contiguous()
    hw = h * wd
    g_x = torch.empty((b, ci, h, wd), dtype=x.dtype, device=x.device)
    tiles = -(-co // _TILE) * -(-ci // _TILE)
    splits = _splits(tiles, b * hw, 256, _K4_BLOCKS)
    partial = torch.empty((splits, co, ci), dtype=torch.float32,
                          device=x.device)
    g_w = torch.empty((co, ci), dtype=torch.float32, device=x.device)
    fn = _build.load("conv_bwd").yolox_conv1x1_bn_silu_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), sx, z.data_ptr(), sz, g_y.data_ptr(), sg,
                 w.data_ptr(), _DTYPE_CODES[x.dtype], coeff.data_ptr(),
                 g_x.data_ptr(), partial.data_ptr(), g_w.data_ptr(), b, ci,
                 co, hw, splits, stream)
    _build.check(err, "main_1x1 kernel")
    main_1x1.launches += 1
    return g_x, g_w


main_1x1.launches = 0


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

def _forward(x, w, gamma, beta, stride, groups, act):
    pad = (w.shape[-1] - 1) // 2
    z = F.conv2d(x, w.to(x.dtype), None, stride, pad, 1, groups)
    mean, var, diff = batch_stats(z)
    inv = torch.rsqrt(var + BN_EPS)
    a = diff * per_channel(inv) * per_channel(gamma) + per_channel(beta)
    return activate(a, act).to(z.dtype), mean, var, z, inv


class _FusedConvBnAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, gamma, beta, stride, groups, act):
        y, mean, var, z, inv = _forward(x, w, gamma, beta, stride, groups,
                                        act)
        ctx.save_for_backward(x, w, gamma, beta, z, mean, inv)
        ctx.conf = (stride, groups, act)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g_y, _g_mean, _g_var):
        x, w, gamma, beta, z, mean, inv = ctx.saved_tensors
        stride, groups, act = ctx.conf
        b, co, oh, ow = z.shape
        n = b * oh * ow
        sdt = stat_dtype(z.dtype)
        gamma32, beta32 = gamma.to(sdt), beta.to(sdt)
        ginv = gamma32 * inv
        wc = w.to(x.dtype)
        if uses_kernels(w.shape[-1], stride, groups, act):
            s1, s2 = reduce_sums(z, g_y, gamma32, beta32, mean, inv)
            coeff = torch.stack([gamma32, beta32, ginv, s1 / n, s2 / n,
                                 mean, inv])
            g_x, g_w = main_1x1(x, z, g_y, wc.reshape(co, -1), coeff)
            g_w = g_w.reshape(w.shape)
        else:
            zh = (z.to(sdt) - per_channel(mean)) * per_channel(inv)
            ga = g_y.to(sdt) * act_grad(
                act, zh * per_channel(gamma32) + per_channel(beta32))
            s1, s2 = ga.sum((0, 2, 3)), (ga * zh).sum((0, 2, 3))
            g_z = (per_channel(ginv) * (ga - per_channel(s1 / n)
                                        - zh * per_channel(s2 / n))
                   ).to(x.dtype)
            pad = (w.shape[-1] - 1) // 2
            g_x = torch.nn.grad.conv2d_input(x.shape, wc, g_z, stride, pad,
                                             1, groups)
            g_w = torch.nn.grad.conv2d_weight(x, wc.shape, g_z, stride, pad,
                                              1, groups)
        return (g_x, g_w.to(w.dtype), s2.to(gamma.dtype), s1.to(beta.dtype),
                None, None, None)


def fused_conv_bn_act(x, w, gamma, beta, stride: int = 1, groups: int = 1,
                      act: str = "silu"):
    """conv -> train-mode BN -> act with the fused backward. x (B, Ci, H,
    W) in the compute dtype; w (Co, Ci/groups, k, k), gamma, beta (Co,)
    the f32 master parameters (w is cast to x's dtype for the conv, its
    gradient comes back f32). 'same' padding (k - 1) // 2. Returns
    (y, mean, var): y in x's dtype, the biased batch statistics f32 (f64
    for f64 inputs)."""
    if act not in ACTS:
        raise AttributeError(f"Unsupported act type: {act}")
    return _FusedConvBnAct.apply(x, w, gamma, beta, stride, groups, act)
