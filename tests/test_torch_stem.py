"""K1, the stem kernel's plain version, against the JAX package's stem.

Held against the Pallas TPU kernel itself (`pallas_stem.stem_conv_bn_act`
in TPU interpret mode on the CPU) and against `blocks.Focus`; the rules
the CUDA kernel's tensor-core path follows (`csrc/stem.cu`: the K order
and padding of `gemm_w`, the weight split of `split3`), written out here
as `_gemm_weight`, `_im2col` and `_bf16_terms`, are held here too.
Tolerances:
float32 outputs at rtol 1e-5 / atol 1e-3 (sums of 108 products of pixel
values); bfloat16 outputs within one bf16 ulp of the reference value
(|d| <= 2^-7 |ref|), the rounding step of the stored result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from yolox_tpu.models import blocks as jb
from yolox_tpu.ops import pallas_stem
from yolox_tpu_torch.models import blocks as tb
from yolox_tpu_torch.ops import stem
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

BF16_ULP = 2.0 ** -7


def _inputs(seed, c=32):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.1, 0.1, (3, 3, 12, c)).astype(np.float32)  # HWIO
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-1, 1, c).astype(np.float32)
    img = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    return w, scale, bias, img


def _folded_both(w):
    """The folded (6, 6, 3, C) kernel in JAX layout and (C, 3, 6, 6) here."""
    wb_j = jb.Focus(3, w.shape[3], ksize=3)._space_to_depth_kernel(
        jnp.asarray(w))
    wb_t = tb.fold_focus_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(wb_t.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(wb_j))
    return wb_j, wb_t


def _assert_bf16_close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6)


def _gemm_weight(wb: torch.Tensor) -> torch.Tensor:
    """The (112, C) B matrix of K1's implicit GEMM: row k = (ky * 6 + kx)
    * 3 + ci holds wb[:, ci, ky, kx] (a tap pair (k, k + 1) is adjacent in
    an NHWC row), rows 108-111 zero."""
    c = wb.shape[0]
    w = wb.permute(2, 3, 1, 0).reshape(108, c)
    return torch.cat([w, w.new_zeros((4, c))])


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """The A matrix of K1's implicit GEMM: (B, H/2, W/2, 112) float64
    patches of the NHWC image x, entry k = (ky * 6 + kx) * 3 + ci at output
    (oy, ox) holding x[2 oy + ky - 2, 2 ox + kx - 2, ci] (0 outside the
    image), the 4 pad entries 0 whatever the image holds."""
    xp = F.pad(x.permute(0, 3, 1, 2).double(), (2, 2, 2, 2))  # (B, 3, H+4, W+4)
    cols = F.unfold(xp, 6, stride=2)                          # (B, 3*36, L)
    b, _, h, w = x.permute(0, 3, 1, 2).shape
    cols = cols.reshape(b, 3, 6, 6, h // 2, w // 2).permute(0, 4, 5, 2, 3, 1)
    cols = cols.reshape(b, h // 2, w // 2, 108)
    return torch.cat([cols, cols.new_zeros(cols.shape[:3] + (4,))], -1)


def _bf16_terms(w: torch.Tensor):
    """(hi, mid, lo): float32 tensors of bf16 values with hi + mid + lo == w
    exactly for float32 w of magnitude 2^-110 or more, or 0 (24 significant
    bits in three 8-bit ones, the last still a normal number), as K1
    splits its weights: hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi
    - mid). For bf16-exact weights mid and lo are 0."""
    hi = w.to(torch.bfloat16).float()
    r = w - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


@pytest.mark.parametrize("act", ["silu", "relu"])
def test_plain_matches_pallas_kernel_uint8_bf16(act):
    """uint8 image -> bf16 activation, the Pallas kernel's serving form.
    Pallas multiplies bf16-rounded weights, so the plain version is given
    the same rounded weights."""
    w, scale, bias, img = _inputs(0)
    wb_j, wb_t = _folded_both(w)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_stem.stem_conv_bn_act(
            jnp.asarray(img), wb_j, jnp.asarray(scale), jnp.asarray(bias),
            jb.get_activation(act))
    assert want.dtype == jnp.bfloat16 and want.shape == (1, 32, 32, 32)
    got = stem.stem_conv_bn_act(
        torch.from_numpy(img), wb_t.to(torch.bfloat16).float(),
        torch.from_numpy(scale), torch.from_numpy(bias), act,
        out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 32, 32)
    _assert_bf16_close(got.float().numpy().transpose(0, 2, 3, 1), want)


def test_plain_matches_pallas_kernel_float32():
    w, scale, bias, img = _inputs(1, c=16)
    wb_j, wb_t = _folded_both(w)
    x = img.astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_stem.stem_conv_bn_act(
            jnp.asarray(x), wb_j, jnp.asarray(scale), jnp.asarray(bias),
            jb.get_activation("silu"))
    assert want.dtype == jnp.float32
    got = stem.stem_conv_bn_act(torch.from_numpy(x), wb_t,
                                torch.from_numpy(scale),
                                torch.from_numpy(bias), "silu")
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-5, atol=1e-3)


def _jax_focus(act, seed):
    jm = jb.Focus(3, 32, ksize=3, act=act)
    rng = np.random.default_rng(seed)
    params = jm.init(rng)
    bn = params["conv"]["bn"]
    bn["running_mean"] = rng.uniform(-5, 5, 32).astype(np.float32)
    bn["running_var"] = rng.uniform(0.5, 4, 32).astype(np.float32)
    bn["weight"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bn["bias"] = rng.uniform(-1, 1, 32).astype(np.float32)
    return jm, params


@pytest.mark.parametrize("pixels", ["uint8", "float32"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_focus(pixels, out_dtype):
    """Through the port's Focus module (the serving caller of the kernel)
    against JAX Focus in f32. For a bf16 module both sides get the
    bf16-rounded weights, and the JAX result is rounded to bf16 once."""
    from yolox_tpu_torch.models.weights import state_dict_from_jax

    jm, params = _jax_focus("silu", 2)
    if out_dtype == "bfloat16":
        params = jax.tree.map(
            lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
            if v.dtype == np.float32 else v, params)
    tm = tb.Focus(3, 32, ksize=3)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tm.eval().to(getattr(torch, out_dtype))
    rng = np.random.default_rng(3)
    if pixels == "uint8":
        img = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    else:
        img = rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jm(params, jnp.asarray(img, jnp.float32)))
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    assert got.shape == (2, 32, 32, 48)
    assert got.dtype == getattr(torch, out_dtype)
    got = got.float().numpy().transpose(0, 2, 3, 1)
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    else:
        want_bf = np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32)
        _assert_bf16_close(got, want_bf)


def test_wrapper_runs_plain_only_on_cpu_and_checks_inputs():
    w, scale, bias, img = _inputs(4)
    wb = tb.fold_focus_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    args = (torch.from_numpy(scale), torch.from_numpy(bias))
    before = stem.stem_conv_bn_act.launches
    out = stem.stem_conv_bn_act(torch.from_numpy(img), wb, *args)
    assert stem.stem_conv_bn_act.launches == before  # plain, no launch
    torch.testing.assert_close(
        out, stem.stem_conv_bn_act_plain(torch.from_numpy(img), wb, *args))
    meta = torch.empty((1, 64, 64, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stem.stem_conv_bn_act(meta, wb, *args)
    with pytest.raises(AttributeError):
        stem.stem_conv_bn_act(torch.from_numpy(img), wb, *args, act="gelu")


def test_gemm_order_matches_pallas_kernel():
    """K1's implicit GEMM in its K order (k = (ky * 6 + kx) * 3 + ci,
    padded to 112 with zero rows and zero A entries), summed in float64,
    then eval BN and SiLU: the Pallas kernel's result."""
    w, scale, bias, img = _inputs(5, c=24)
    wb_j, wb_t = _folded_both(w)
    x = torch.from_numpy(img)
    a = _im2col(x)
    bm = _gemm_weight(wb_t)
    assert a.shape == (1, 32, 32, 112) and bm.shape == (112, 24)
    assert not bm[108:].any() and not a[..., 108:].any()
    # entry k of output (oy, ox) is x[2 oy + ky - 2, 2 ox + kx - 2, ci]
    for k, oy, ox in ((0, 0, 0), (17, 5, 9), (59, 31, 31), (107, 12, 3)):
        ky, kx, ci = k // 18, k % 18 // 3, k % 3
        iy, ix = 2 * oy + ky - 2, 2 * ox + kx - 2
        want = float(img[0, iy, ix, ci]) if 0 <= iy < 64 and 0 <= ix < 64 \
            else 0.0
        assert float(a[0, oy, ox, k]) == want
        assert torch.equal(bm[k], wb_t[:, ci, ky, kx])
    acc = (a.double() @ bm.double()).float()
    got = F.silu(acc * torch.from_numpy(scale) + torch.from_numpy(bias))
    with pltpu.force_tpu_interpret_mode():
        want = pallas_stem.stem_conv_bn_act_s2d(
            pallas_stem.s2d_prepare(jnp.asarray(img.astype(np.float32))),
            wb_j, jnp.asarray(scale), jnp.asarray(bias),
            jb.get_activation("silu"), out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    # the pad entries stay 0 whatever a float image holds
    bad = x.float().clone()
    bad[0, :4] = float("nan")
    assert not _im2col(bad)[..., 108:].any()


def test_bf16_terms_split_weights_exactly():
    """Each term is bf16-exact and hi + mid + lo is the float32 weight
    (24 significant bits in three of 8) from 2^-110 to the largest float32;
    a bf16 weight
    is its own hi, with mid and lo 0 (the kernel then runs one product)."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy((rng.standard_normal(20000)
                          * 10.0 ** rng.uniform(-30, 30, 20000)).astype(
        np.float32))
    w = torch.cat([w, torch.tensor([0.0, -0.0, 1.0, -2.0 ** -110, 3.3e38])])
    hi, mid, lo = _bf16_terms(w)
    for t in (hi, mid, lo):
        assert t.dtype == torch.float32
        assert torch.equal(t.bfloat16().float(), t)
    assert torch.equal((hi + mid) + lo, w)
    assert (mid.abs() <= 2.0 ** -8 * hi.abs()).all()
    w16 = w.bfloat16().float()
    hi16, mid16, lo16 = _bf16_terms(w16)
    assert torch.equal(hi16, w16) and not mid16.any() and not lo16.any()
    # three bf16 products summed exactly give the float32 weight's product
    px = torch.from_numpy(rng.integers(0, 256, 5000).astype(np.float64))
    ws = w[:5000].double()
    split = sum(px * t[:5000].double() for t in (hi, mid, lo))
    assert torch.equal(split, px * ws)
