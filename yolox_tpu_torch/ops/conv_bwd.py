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
  (`reduce_sums`, replaces `pallas_conv_bwd.py::_reduce_kernel`; one
  launch that also writes K4's coefficient table) and g_z with both
  products as K4 (`main_1x1`, replaces `_main_kernel_1x1`): g_z is made
  once into a scratch tensor in the activation dtype, then the two
  products read it (design note in `csrc/conv_bwd.cu`).

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

import functools
import struct
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.stem import activate

BN_EPS = 1e-3
ACTS = ("silu", "lrelu", "relu")
_F32 = torch.float32
_DTYPE_CODES = {_F32: 1, torch.bfloat16: 2}
# Launch arithmetic (`launch_plan`). Aims: about 8 resident 256-thread
# blocks on each of 132 SMs in K3 (one channel a warp, 8 a block), each
# warp reducing at least _K3_MIN_ROWS rows; about 2 resident blocks an SM
# in K4's split-K wgrad (at most one wave), each split at least
# _K4_MIN_TILES k tiles long.
_K3_CHANNELS = 8
_K3_BLOCKS = 1056
_K3_MIN_ROWS = 1024
_K4_TILE = 128
_K4_BK = {2: 64, 4: 16}  # wgrad k-tile depth (positions) by element bytes
_K4_BLOCKS = 264
_K4_MIN_TILES = 8
# The launchers' argument structs, one 8-byte slot each, in the order of
# `ReduceArgs` / `MainArgs` in csrc/conv_bwd.cu (null pointers as 0).
_K3_ARGS = struct.Struct("<19q")
_K4_ARGS = struct.Struct("<21q")


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


def _nchw_view(t, chw):
    """t itself when each image's (C, H, W) block (`chw` elements) is
    contiguous (any batch stride), else a contiguous copy. Returns
    (tensor, batch stride)."""
    if t.is_contiguous():
        return t, chw
    b, c, h, w = t.shape
    if not (t.stride(3) == 1 and t.stride(2) == w and t.stride(1) == h * w
            and (b == 1 or t.stride(0) >= chw)):
        return t.contiguous(), chw
    return t, (t.stride(0) if b > 1 else chw)


class LaunchPlan(NamedTuple):
    """Grids of K3 and K4 for one (B, Ci, Co, HW) and element size."""
    k3_blocks: int      # blocks along the channels (8 channels a block)
    k3_splits: int      # row ranges of each channel
    k3_per: int         # rows a range (a multiple of 8); range s covers
    #                     rows [s * per, min((s + 1) * per, B * HW))
    k4_bk: int          # wgrad k tile: positions of one image
    k4_ntiles: int      # k tiles: B * ceil(HW / bk); tile t covers
    #                     positions [p0, min(p0 + bk, HW)) of image
    #                     t // ceil(HW / bk), p0 = bk * (t % ceil(HW / bk))
    k4_tps: int         # k tiles a split; split s takes [s * tps, ...)
    k4_splits: int      # wgrad splits (1: no partial sums)
    k4_dgrad_grid: Tuple[int, int, int]  # (HW tiles, Ci tiles, B)
    k4_wgrad_grid: Tuple[int, int, int]  # (Ci tiles, Co tiles, splits)


@functools.lru_cache(maxsize=None)
def launch_plan(b, ci, co, hw, elt_bytes) -> LaunchPlan:
    """The launch arithmetic of K3 and K4 (see `LaunchPlan`). K3's
    channels are K4's Co; element sizes 4 (float32) or 2 (bf16)."""
    rows = b * hw
    k3_blocks = -(-co // _K3_CHANNELS)
    want = max(1, min(-(-_K3_BLOCKS // k3_blocks), rows // _K3_MIN_ROWS))
    per = -(-rows // want)
    per += -per % 8      # a whole number of 16-byte vectors of any dtype
    k3_splits = -(-rows // per)
    bk = _K4_BK[elt_bytes]
    ntiles = b * -(-hw // bk)
    t = _K4_TILE
    ci_t, co_t = -(-ci // t), -(-co // t)
    want = max(1, min(_K4_BLOCKS // (ci_t * co_t), ntiles // _K4_MIN_TILES))
    tps = -(-ntiles // want)
    k4_splits = -(-ntiles // tps)
    return LaunchPlan(k3_blocks, k3_splits, per, bk, ntiles, tps, k4_splits,
                      (-(-hw // t), ci_t, b), (ci_t, co_t, k4_splits))


def vector_width(elt_bytes, lengths, ptrs) -> int:
    """Elements a kernel load may take at once: 16 bytes' worth when every
    length (HW, batch strides, Ci, in elements) is a multiple of it and
    every pointer is 16-byte aligned, else 1 (masked element loads)."""
    e = 16 // elt_bytes
    for n in lengths:
        if n % e:
            return 1
    for q in ptrs:
        if q & 15:
            return 1
    return e


# Per (device, stream): a float32 scratch buffer. Element 0 is K3's
# arrival counter (0 between launches, reset by the kernel itself);
# partial sums start at element 4 (16 bytes in). Launches on one stream
# run in order, so they share it.
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _scratch_for(device, stream, n):
    """The address of the scratch of `device`'s `stream`, grown to hold n
    partial sums."""
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < 4 + n:
        buf = torch.zeros(4 + n, dtype=_F32, device=device)
        _scratch[key] = buf
    return buf.data_ptr()


def _f32_vectors(vs, c, index):
    """(C,) float32 contiguous forms of the tensors `vs` on CUDA device
    `index` (cast when needed)."""
    out = []
    for v in vs:
        if (v.dtype is not _F32 or v.shape != (c,) or not v.is_contiguous()
                or v.get_device() != index):
            v = v.to(_F32).contiguous()
            if v.shape != (c,) or v.get_device() != index:
                raise ValueError(f"gamma, beta, mean, inv must be ({c},) on "
                                 f"cuda:{index}")
        out.append(v)
    return out


def _cuda_dtype(name, dtype, tensors, index):
    """The launcher's code of `dtype`; raises unless every tensor has that
    dtype and lies on CUDA device `index`."""
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(f"{name}: dtype {dtype} not supported (float32, "
                         "bfloat16)")
    for t in tensors:
        if t.dtype != dtype or t.get_device() != index:
            raise ValueError(f"{name}: all inputs must be {dtype} on "
                             f"cuda:{index}")
    return code


def coeff_table(s, n, gamma, beta, mean, inv):
    """K4's (7, C) coefficients from K3's sums `s` over `n` positions:
    gamma, beta, gamma * inv, S1/N, S2/N, mean, inv."""
    return torch.stack([gamma, beta, gamma * inv, s[0] / n, s[1] / n, mean,
                        inv])


def reduce_sums(z, g_y, gamma, beta, mean, inv, coeff: bool = False):
    """K3: (2, C) float32 S1, S2 (see `reduce_sums_plain`); with `coeff`,
    (sums, the (7, C) table of `coeff_table`), both from one launch."""
    if not z.is_cuda:
        if z.device.type != "cpu":
            raise ValueError(f"reduce_sums: unsupported device {z.device}")
        s = reduce_sums_plain(z, g_y, gamma, beta, mean, inv)
        if not coeff:
            return s
        b, _, h, w = z.shape
        return s, coeff_table(s, b * h * w, gamma, beta, mean, inv)
    dev = z.device
    index = dev.index
    code = _cuda_dtype("reduce_sums", z.dtype, (g_y,), index)
    shape = z.shape
    if g_y.shape != shape or len(shape) != 4:
        raise ValueError(f"reduce_sums: z {tuple(shape)} and g_y "
                         f"{tuple(g_y.shape)} must be one (B, C, H, W) shape")
    b, c, h, w = shape
    hw = h * w
    g, be, m, iv = _f32_vectors((gamma, beta, mean, inv), c, index)
    z, sz = _nchw_view(z, c * hw)
    g_y, sg = _nchw_view(g_y, c * hw)
    zp, gp = z.data_ptr(), g_y.data_ptr()
    elt = 4 if code == 1 else 2
    plan = launch_plan(b, c, c, hw, elt)
    ctr = _scratch_for(dev, _build.stream(dev), 2 * plan.k3_splits * c)
    out = torch.empty(2, c, dtype=_F32, device=dev)
    table = torch.empty(7, c, dtype=_F32, device=dev) if coeff else None
    _build.launch(_build.load("conv_bwd").yolox_bn_silu_reduce, dev,
                  "reduce_sums kernel", _K3_ARGS.pack(
                      zp, sz, gp, sg, code,
                      vector_width(elt, (hw, sz, sg), (zp, gp)) > 1,
                      g.data_ptr(), be.data_ptr(), m.data_ptr(),
                      iv.data_ptr(), ctr, ctr + 16, out.data_ptr(),
                      table.data_ptr() if coeff else 0, b, c, hw,
                      plan.k3_per, plan.k3_splits))
    reduce_sums.launches += 1
    return (out, table) if coeff else out


reduce_sums.launches = 0


# ---------------------------------------------------------------------------
# K4 (1x1): g_z once -> dgrad g_x = W^T g_z, wgrad g_W = g_z X^T
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
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"main_1x1: unsupported device {x.device}")
        return main_1x1_plain(x, z, g_y, w, coeff)
    dev = x.device
    index = dev.index
    code = _cuda_dtype("main_1x1", x.dtype, (z, g_y, w), index)
    b, ci, h, wd = x.shape
    co = z.shape[1]
    if (z.shape != (b, co, h, wd) or g_y.shape != z.shape
            or w.shape != (co, ci)):
        raise ValueError(
            f"main_1x1: shapes x {tuple(x.shape)}, z {tuple(z.shape)}, g_y "
            f"{tuple(g_y.shape)}, w {tuple(w.shape)} do not form a 1x1 conv")
    if coeff.dtype is not _F32 or not coeff.is_contiguous():
        coeff = coeff.to(_F32).contiguous()
    if coeff.shape != (7, co) or coeff.get_device() != index:
        raise ValueError(f"main_1x1: coeff must be (7, Co) on {dev}")
    hw = h * wd
    x, sx = _nchw_view(x, ci * hw)
    z, sz = _nchw_view(z, co * hw)
    g_y, sg = _nchw_view(g_y, co * hw)
    w = w.contiguous()
    xp, zp, gp, wp = x.data_ptr(), z.data_ptr(), g_y.data_ptr(), w.data_ptr()
    elt = 4 if code == 1 else 2
    vec = vector_width(elt, (hw, sx, sz, sg, ci), (xp, zp, gp, wp)) > 1
    plan = launch_plan(b, ci, co, hw, elt)
    dtype = x.dtype
    g_z = torch.empty(b, co, hw, dtype=dtype, device=dev)
    g_x = torch.empty(b, ci, h, wd, dtype=dtype, device=dev)
    g_w = torch.empty(co, ci, dtype=_F32, device=dev)
    partial = 0
    if plan.k4_splits > 1:  # per-split sums from element 4 of the scratch
        partial = _scratch_for(dev, _build.stream(dev),
                               plan.k4_splits * co * ci) + 16
    _build.launch(_build.load("conv_bwd").yolox_conv1x1_bn_silu_bwd, dev,
                  "main_1x1 kernel", _K4_ARGS.pack(
                      xp, sx, zp, sz, gp, sg, wp, code, vec,
                      coeff.data_ptr(), g_z.data_ptr(), g_x.data_ptr(),
                      partial, g_w.data_ptr(), b, ci, co, hw, plan.k4_tps,
                      plan.k4_ntiles, plan.k4_splits))
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
        wc = w.to(x.dtype)
        if uses_kernels(w.shape[-1], stride, groups, act):
            (s1, s2), coeff = reduce_sums(z, g_y, gamma32, beta32, mean, inv,
                                          coeff=True)
            g_x, g_w = main_1x1(x, z, g_y, wc.reshape(co, -1), coeff)
            g_w = g_w.reshape(w.shape)
        else:
            ginv = gamma32 * inv
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
