"""Q1 and Q2: the int8 convolutions of the PTQ serving path
(`csrc/int8_conv.cu`).

The JAX package runs each quantized conv as
`lax.conv_general_dilated(int8, int8, preferred_element_type=int32)` on the
TPU's matrix unit (`yolox_tpu/ops/quant.py:127-135, 230-238`); no Pallas
kernel is replaced, and PyTorch has no int8 convolution on CUDA. Q1 is the
dense conv (groups 1) as an implicit GEMM on Hopper's warpgroup MMA
(`wgmma` m64nNk32 s8 x s8 -> s32, exact int32 sums), Q2 the depthwise conv
on the CUDA cores. Both apply one fused epilogue per output channel c,

    y = act(float(acc) * scale[c] + bias[c])    (SiLU in float64)

and store y as float32 or bfloat16, or requantize it to int8 codes at
`out_scale[c]`.

Bound on an H100 (`chip_smoke.int8_conv_bound`): operations only for the
3x3 convs of 128+ channels at large B, bytes for every other shape, and
beside both the float64 SiLU of each output, which the bound does not
count. So Q1 moves each byte once and in 16-byte pieces: an N tile of all
of Cout up to 256 gathers the activation tile once for every channel,
tiles reach shared memory by 16-byte `cp.async` (or, for a 3-channel
stem, from an input window copied once), and the epilogue stages the tile
in shared memory and writes 16 bytes a thread along NHWC rows. Q2 copies
an input halo and its weights to shared memory once and computes 16
channels a thread. `q1_plan` / `q2_plan` are the kernels' launch choices
in Python: the wrappers pass them to the launchers, which refuse a plan
whose shared memory is not what its layout needs.

Codes go in and come out as logical NCHW tensors stored NHWC
(`torch.channels_last`), so concat, upsampling and pooling keep working on
them. `pack_weight` / `pack_dw_weight` lay the int8 OIHW weights out for
the kernels once (`ops/quant.py` caches them per module).

`int8_conv` / `int8_dwconv` launch the kernels for CUDA tensors and run
the plain PyTorch versions, `int8_conv_plain` / `int8_dwconv_plain`, only
for CPU tensors: the same integer conv as `F.conv2d` in float64 on the
codes (exact: |acc| <= 5760 * 127^2 < 2^53), then the same epilogue with
separate torch ops. Under `torch.export` both wrappers call the registered
operators of `ops/library.py`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from yolox_tpu_torch.ops import _build
from yolox_tpu_torch.ops.library import exportable
from yolox_tpu_torch.ops.stem import activate

_ACT_CODES = {"silu": 0, "relu": 1, "lrelu": 2}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}  # 2: int8 at out_scale
MAX_SMEM = 232448          # 227 KB: a block's most shared memory on sm_90
SMS = 132                  # H100 SXM streaming multiprocessors
# the N widths `wgmma` m64nNk32 takes for s8 operands (PTX ISA), and those
# Q1 instantiates: cp.async rows, and the window patch
WGMMA_S8_N = (8, 16, 24) + tuple(range(32, 257, 16))
Q1_N = (16, 32, 64, 128)
Q1_PATCH_N = (16, 32, 64)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _out_hw(h: int, w: int, ksize: int, stride: int) -> Tuple[int, int]:
    pad = (ksize - 1) // 2
    return ((h + 2 * pad - ksize) // stride + 1,
            (w + 2 * pad - ksize) // stride + 1)


def k_tile(ksize: int, cin: int) -> int:
    """Q1's k tile in bytes, also the swizzle width of its shared-memory
    rows: the smallest of 32, 64, 128 that holds K = ksize^2 cin, else
    128."""
    k = ksize * ksize * cin
    return 32 if k <= 32 else 64 if k <= 64 else 128


def padded_k(ksize: int, cin: int) -> int:
    """K = ksize^2 cin rounded up to a whole k tile (`k_tile`)."""
    return _cdiv(ksize * ksize * cin, k_tile(ksize, cin)) * \
        k_tile(ksize, cin)


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW (Cout, Cin, k, k) -> Q1's (Cout, Kp): K in the order
    (ky, kx, ci), zeros past K = k^2 Cin up to `padded_k`."""
    cout, cin, k, _ = wq.shape
    w = wq.permute(0, 2, 3, 1).reshape(cout, k * k * cin)
    return F.pad(w, (0, padded_k(k, cin) - w.shape[1])).contiguous()


class Q1Plan(NamedTuple):
    """Q1's launch: `patch` (the block takes a `tr` x `tc` patch of one
    image, its `wr` x `wc` input window in shared memory; else `bm`
    consecutive output pixels by 16-byte cp.async), `bm` output pixels
    and `bn` channels a block (`n_tiles` tiles of Cout), k tile and
    swizzle `bk` bytes, `kp` the padded K, ring `stages`, `threads`,
    `grid` (x, y) and the dynamic shared memory `smem` in bytes."""

    patch: bool
    bm: int
    bn: int
    n_tiles: int
    bk: int
    kp: int
    stages: int
    threads: int
    grid: Tuple[int, int]
    smem: int
    tr: int
    tc: int
    wr: int
    wc: int


def q1_smem(bm: int, bn: int, bk: int, stages: int, window: int,
            k_tiles: int) -> int:
    """Q1's dynamic shared memory: 1024 bytes of alignment slack, the ring
    (A and B tiles a stage, min(`stages`, `k_tiles`) of them) and the
    window, or the int32 staging tile of the epilogue where that is
    larger, then the epilogue's tables (scale, bias, out_scale and its
    reciprocal)."""
    ring = min(stages, k_tiles) * (bm + bn) * bk
    if window:  # 32 bytes of slack on each side
        ring += _cdiv(window, 16) * 16 + 64
    staging = bm * (bn + 8) * 4
    return 1024 + _cdiv(max(ring, staging), 16) * 16 + 16 * bn


@functools.lru_cache(maxsize=1024)
def q1_plan(b: int, h: int, w: int, cin: int, cout: int, ksize: int,
            stride: int, aligned: bool = True, sms: int = SMS) -> Q1Plan:
    """Q1's launch choices for a conv of B `b` (H, W) `cin` -> `cout`,
    `ksize`, `stride` ('same' padding); `aligned`: the codes are 16-byte
    aligned. The cp.async path needs cin % 16 == 0 and aligned codes, any
    other input takes the window patch (BM 128, N up to 64; k cin >= 8,
    else it raises). N is Cout rounded up to a width Q1 is built for, at
    most 128; Cout beyond that takes several N tiles. BM is 128 for the
    tensor cores' reuse of each tile, but 64 where a block is short (one
    or two k tiles) or narrow (N <= 32), so that more blocks are in
    flight (`scripts/torch_int8_ab.py --sweep`). While the grid has
    fewer blocks than `sms`, N halves down to 64, then BM drops to 64.
    The ring takes 4 stages up to 3 k tiles (no more shared memory than
    3), else 3, so that two 128 x 128 blocks fit on an SM. Raises where
    the window does not fit in shared memory."""
    ho, wo = _out_hw(h, w, ksize, stride)
    if min(b, h, w, cin, cout, ksize, stride, ho, wo) < 1:
        raise ValueError(f"Q1: no output for {(b, cin, cout, h, w)} at "
                         f"k {ksize} stride {stride}")
    m = b * ho * wo
    bk = k_tile(ksize, cin)
    kp = padded_k(ksize, cin)
    nk = kp // bk
    patch = not (cin % 16 == 0 and aligned)
    tr, tc, wr, wc, window = 0, 0, 0, 0, 0
    if patch and ksize * cin < 8:
        raise ValueError(f"Q1: the window patch takes runs of k Cin >= 8 "
                         f"bytes, not {ksize}x{ksize} x {cin} channels")
    if patch:
        bm = 128
        bn = next(n for n in Q1_PATCH_N if n >= min(cout, Q1_PATCH_N[-1]))
        tc = min(64, max(8, _pow2_at_least(wo)))
        tr = bm // tc
        wr, wc = (tr - 1) * stride + ksize, (tc - 1) * stride + ksize
        window = wr * wc * cin
        gx = b * _cdiv(ho, tr) * _cdiv(wo, tc)
    else:
        bm = 64 if nk <= 2 or cout <= 32 else 128
        bn = next(n for n in Q1_N if n >= min(cout, Q1_N[-1]))
        while _cdiv(m, bm) * _cdiv(cout, bn) < sms:
            if bn > 64:
                bn //= 2
            elif bm == 128:
                bm = 64
            else:
                break
        gx = _cdiv(m, bm)
    stages = 4 if nk <= 3 else 3
    smem = q1_smem(bm, bn, bk, stages, window, nk)
    if smem > MAX_SMEM:
        raise ValueError(f"Q1: {smem} bytes of shared memory for "
                         f"{(b, cin, cout, h, w)} k {ksize} (the most is "
                         f"{MAX_SMEM}): the input window of a "
                         f"{tr}x{tc} patch is too large")
    n_tiles = _cdiv(cout, bn)
    return Q1Plan(patch, bm, bn, n_tiles, bk, kp, stages, 2 * bm,
                  (gx, n_tiles), smem, tr, tc, wr, wc)


class Q2Plan(NamedTuple):
    """Q2's launch: `vec` (16-byte cp.async of the halo), `cg` channels a
    block (16 each of `cg` / 16 threads a pixel), a `th` x `tw` output
    tile and its `hr` x `hc` input halo, 256 threads, `grid` (x, y), the
    dynamic shared memory `smem` (halo, weights, epilogue tables)."""

    vec: bool
    cg: int
    th: int
    tw: int
    hr: int
    hc: int
    grid: Tuple[int, int]
    smem: int


@functools.lru_cache(maxsize=1024)
def q2_plan(b: int, h: int, w: int, c: int, ksize: int, stride: int,
            aligned: bool = True) -> Q2Plan:
    """Q2's launch choices for a depthwise conv of B `b` (H, W) `c`
    channels: a channel group of 16, 32 or 64 (the smallest that holds C,
    else 64), a tile of up to 32 columns and 256 / (cg / 16) pixels.
    Raises where the halo does not fit in shared memory."""
    ho, wo = _out_hw(h, w, ksize, stride)
    if min(b, h, w, c, ksize, stride, ho, wo) < 1:
        raise ValueError(f"Q2: no output for {(b, c, h, w)} at k {ksize} "
                         f"stride {stride}")
    cg = 16 if c <= 16 else 32 if c <= 32 else 64
    tw = min(32, _pow2_at_least(wo))
    th = 256 // (cg // 16) // tw
    hr, hc = (th - 1) * stride + ksize, (tw - 1) * stride + ksize
    smem = hr * hc * cg + ksize * ksize * cg + 12 * cg
    if smem > MAX_SMEM:
        raise ValueError(f"Q2: {smem} bytes of shared memory for "
                         f"{(b, c, h, w)} k {ksize} (the most is "
                         f"{MAX_SMEM})")
    grid = (b * _cdiv(ho, th) * _cdiv(wo, tw), _cdiv(c, cg))
    return Q2Plan(c % 16 == 0 and aligned, cg, th, tw, hr, hc, grid, smem)


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


_ready = {}  # device index -> streaming multiprocessors, once set up


def _library(device: torch.device):
    """The kernels' library, with the shared-memory limit of every Q1 / Q2
    kernel raised on `device` the first time it is used there."""
    lib = _build.load("int8_conv")
    if device.index not in _ready:
        with torch.cuda.device(device):
            _build.check(lib.yolox_int8_init(), "Q1/Q2 setup")
        _ready[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return lib


def _sms(device: torch.device) -> int:
    _library(device)
    return _ready[device.index]


def epilogue_mismatches(device) -> int:
    """On how many of all 2^32 float inputs the kernels' branch-free
    float64 SiLU differs from y / (1 + exp(-y)) in float64 rounded once
    (CUDA's exp and division; NaN equal to NaN), or their branch-free
    requant from clamp(rint(y / s), -127, 127) with IEEE division at any
    of eight scales s, on CUDA `device`."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    count = torch.zeros(1, dtype=torch.int64, device=device)
    _build.launch(_library(device).yolox_int8_epilogue_mismatches, device,
                  "SiLU check", count.data_ptr())
    return int(count.item())


@exportable("int8_conv")
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
    b, _, h, wd = x.shape
    cout = w.shape[0]
    plan = q1_plan(b, h, wd, cin, cout, ksize, stride,
                   x.data_ptr() % 16 == 0, _sms(x.device))
    out = _launch(_library(x.device).yolox_int8_conv, "Q1", x, w, scale,
                  bias, ksize, stride, act, out_dtype, out_scale, cout,
                  (cin, cout), (int(plan.patch), plan.bm, plan.bn, plan.bk,
                                plan.stages, plan.tc, plan.smem))
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


@exportable("int8_dwconv")
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
    b, _, h, wd = x.shape
    plan = q2_plan(b, h, wd, c, ksize, stride, x.data_ptr() % 16 == 0)
    out = _launch(_library(x.device).yolox_int8_dwconv, "Q2", x, w, scale,
                  bias, ksize, stride, act, out_dtype, out_scale, c, (c,),
                  (int(plan.vec), plan.cg, plan.tw, plan.smem))
    int8_dwconv.launches += 1
    return out


int8_dwconv.launches = 0
