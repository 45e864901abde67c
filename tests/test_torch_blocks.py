"""The PyTorch port's modules against the JAX package's, module by module.

Same weights (the JAX module's `init` from a numpy seed, BN statistics
randomized, moved across with `state_dict_from_jax`) and the same inputs
(numpy seeds), on the CPU in float32. Tolerance: rtol 1e-4, atol 1e-4 on
activations of order 1 (the two frameworks sum convolutions in different
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolox_tpu.models import blocks as jb
from yolox_tpu.models.darknet import CspDarknet as JCspDarknet
from yolox_tpu.models.head import YoloxHead as JYoloxHead
from yolox_tpu.models.pafpn import YoloPafpn as JYoloPafpn
from yolox_tpu_torch.models import blocks as tb
from yolox_tpu_torch.models.darknet import CspDarknet
from yolox_tpu_torch.models.head import YoloxHead
from yolox_tpu_torch.models.pafpn import YoloPafpn
from yolox_tpu_torch.models.weights import (
    nested_to_flat,
    state_dict_from_jax,
    state_dict_to_jax,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

RTOL = ATOL = 1e-4


def _randomize_bn(tree, rng):
    """BN statistics and affine terms away from their identity init."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if "running_var" in v:
                c = v["running_var"].shape
                v["weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["bias"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
                v["running_mean"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
                v["running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            else:
                _randomize_bn(v, rng)
    return tree


def _pair(jmod, tmod, seed=0):
    """Init the JAX module, copy its weights into the port's module."""
    rng = np.random.default_rng(seed)
    params = _randomize_bn(jmod.init(rng), rng)
    tmod.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, tmod.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _image(seed, b, h, w, c):
    return np.random.default_rng(seed).uniform(-1, 1, (b, h, w, c)).astype(
        np.float32)


@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
@pytest.mark.parametrize("ksize,stride", [(1, 1), (3, 1), (3, 2)])
def test_base_conv(ksize, stride, act):
    params, tmod = _pair(jb.BaseConv(16, 24, ksize, stride, act=act),
                         tb.BaseConv(16, 24, ksize, stride, act=act))
    x = _image(1, 2, 20, 20, 16)
    want = np.asarray(jb.BaseConv(16, 24, ksize, stride, act=act)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_dw_conv(stride):
    jm = jb.DWConv(16, 32, 3, stride)
    params, tmod = _pair(jm, tb.DWConv(16, 32, 3, stride))
    x = _image(2, 2, 16, 16, 16)
    want = np.asarray(jm(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shortcut,depthwise", [(True, False), (False, False),
                                                (True, True)])
def test_csp_layer(shortcut, depthwise):
    jm = jb.CspLayer(16, 32, n=2, shortcut=shortcut, depthwise=depthwise)
    params, tmod = _pair(jm, tb.CspLayer(16, 32, n=2, shortcut=shortcut,
                                         depthwise=depthwise))
    x = _image(3, 2, 16, 16, 16)
    want = np.asarray(jm(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_spp_bottleneck():
    jm = jb.SPPBottleneck(32, 32)
    params, tmod = _pair(jm, tb.SPPBottleneck(32, 32))
    x = _image(4, 2, 16, 16, 32)
    want = np.asarray(jm(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_upsample_nearest_2x():
    x = _image(5, 2, 5, 7, 8)
    want = np.asarray(jb.upsample_nearest_2x(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(tb.upsample_nearest_2x(_nchw(x))), want)


@pytest.mark.parametrize("act", ["silu", "lrelu"])
@pytest.mark.parametrize("pixels", ["uint8", "float"])
def test_focus(pixels, act):
    """The port's Focus (stem kernel, plain version on the CPU) reads the
    NHWC image itself, uint8 or float, and writes NCHW."""
    jm = jb.Focus(3, 16, ksize=3, act=act)
    params, tmod = _pair(jm, tb.Focus(3, 16, ksize=3, act=act))
    rng = np.random.default_rng(6)
    if pixels == "uint8":
        img = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    else:
        img = rng.uniform(0, 255, (2, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jm(params, jnp.asarray(img, jnp.float32)))
    got = _nhwc(tmod(torch.from_numpy(img)))
    # pixel-scale inputs: sums of 108 products of order 100
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


def test_focus_weight_fold_matches_jax():
    jm = jb.Focus(3, 8, ksize=3)
    w = np.random.default_rng(7).uniform(-1, 1, (3, 3, 12, 8)).astype(
        np.float32)
    want = np.asarray(jm._space_to_depth_kernel(jnp.asarray(w)))  # HWIO
    got = tb.fold_focus_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


@pytest.mark.parametrize("depthwise", [False, True])
def test_csp_darknet(depthwise):
    kw = dict(depthwise=depthwise)
    jm = JCspDarknet(0.33, 0.125, lane_fold=False, **kw)
    params, tmod = _pair(jm, CspDarknet(0.33, 0.125, **kw))
    img = np.random.default_rng(8).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    want = jm(params, jnp.asarray(img))
    got = tmod(torch.from_numpy(img))
    assert set(got) == set(want) == {"dark3", "dark4", "dark5"}
    for k in want:
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-3, err_msg=k)


def test_pafpn_nano_width():
    jm = JYoloPafpn(0.33, 0.25, depthwise=True, lane_fold=False)
    params, tmod = _pair(jm, YoloPafpn(0.33, 0.25, depthwise=True))
    img = np.random.default_rng(9).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    want = jm(params, jnp.asarray(img))
    with torch.no_grad():
        got = tmod(torch.from_numpy(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=RTOL,
                                   atol=1e-3)


@pytest.fixture(scope="module")
def nano_head():
    jm = JYoloxHead(80, 0.25, depthwise=True)
    params, tmod = _pair(jm, YoloxHead(80, 0.25, depthwise=True), seed=10)
    rng = np.random.default_rng(11)
    xin = [rng.uniform(-1, 1, (2, s, s, c)).astype(np.float32)
           for s, c in ((8, 64), (4, 128), (2, 256))]
    return jm, params, tmod, xin


def test_head_forward_raw_levels(nano_head):
    jm, params, tmod, xin = nano_head
    want = jm.forward_raw_levels(params, [jnp.asarray(x) for x in xin])
    with torch.no_grad():
        got = tmod.forward_raw_levels([_nchw(x) for x in xin])
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_head_decode(nano_head):
    jm, params, tmod, xin = nano_head
    want = np.asarray(jm(params, [jnp.asarray(x) for x in xin]))
    with torch.no_grad():
        got = tmod([_nchw(x) for x in xin]).numpy()
    assert got.shape == want.shape == (2, 84, 85)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_level_grid_and_exact_int_bound():
    from yolox_tpu.models.head import exact_int_bound as j_bound
    from yolox_tpu.models.head import level_grid as j_grid
    from yolox_tpu_torch.models.head import exact_int_bound, level_grid

    assert exact_int_bound(torch.float32) == j_bound(jnp.float32) == 2 ** 24
    assert exact_int_bound(torch.bfloat16) == j_bound(jnp.bfloat16) == 256
    for h, w, jdt, tdt in ((3, 5, jnp.float32, torch.float32),
                           (300, 2, jnp.bfloat16, torch.bfloat16)):
        want = j_grid(h, w, jdt)
        got = level_grid(h, w, tdt)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_state_dict_round_trip():
    jm = jb.CspLayer(8, 8, n=1)
    params = jm.init(np.random.default_rng(12))
    sd = state_dict_from_jax(params)
    assert sd["conv1.conv.weight"].shape == (4, 8, 1, 1)
    assert sd["conv1.bn.num_batches_tracked"].dtype == torch.int64
    back = nested_to_flat(state_dict_to_jax(sd))
    for k, v in nested_to_flat(params).items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v)
    # the flat key form converts the same way
    flat = state_dict_from_jax(nested_to_flat(params))
    assert all(torch.equal(flat[k], sd[k]) for k in sd)
