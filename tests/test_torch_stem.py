"""K1, the stem kernel's plain version, against the JAX package's stem.

Held against the Pallas TPU kernel itself (`pallas_stem.stem_conv_bn_act`
in TPU interpret mode on the CPU) and against `blocks.Focus`. Tolerances:
float32 outputs at rtol 1e-5 / atol 1e-3 (sums of 108 products of pixel
values); bfloat16 outputs within one bf16 ulp of the reference value
(|d| <= 2^-7 |ref|), the rounding step of the stored result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yolox_tpu.models import blocks as jb
from yolox_tpu.ops import pallas_stem
from yolox_tpu_torch.models import blocks as tb
from yolox_tpu_torch.ops import stem

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
