"""The eval epilogue (`ops/bn_act.py`) and BaseConv's float eval path on
the CPU.

- `bn_act_plain` against eval BN then the activation (`act(bn(z))`) at
  float32 tolerance (rtol 1e-5, atol 1e-6: BN as a float32 fold, y = z *
  scale + bias, against BN's (z - mean) * inv * gamma + beta), for silu,
  relu and lrelu, NCHW and channels_last, in z's dtype and memory format;
  in bf16 BN's output rounded to bf16 before the activation;
- a BaseConv's eval output against the unfused module's at
  `tests/test_torch_blocks.py`'s tolerance (rtol 1e-4, atol 1e-4);
- the cached fold made anew after `load_params`, `cast_params` and an
  in-place change of a BN buffer, and not cached while autograd records;
- the registered operator's gradients (z, scale, bias) equal to the
  plain version's;
- a float serving function exported with `yolox_tpu_torch::bn_act` in its
  graph, one node a BaseConv, equal to the eager call; the operator's
  fake output has the real one's shape, dtype and strides.

The kernel itself is held to `bn_act_plain` on the card
(`tests/test_torch_cuda.py -k bn_act`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolox_tpu_torch import YoloxConfig
from yolox_tpu_torch.models import blocks
from yolox_tpu_torch.models.yolox import YoloxModule
from yolox_tpu_torch.ops.bn_act import bn_act, bn_act_plain
from yolox_tpu_torch.ops.library import exported_ops
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

SIZE = 64


def _bn(c, seed):
    """An eval BatchNorm2d with its statistics and affine terms away from
    the identity."""
    rng = np.random.default_rng(seed)
    bn = torch.nn.BatchNorm2d(c, eps=blocks.BN_EPS).eval()
    with torch.no_grad():
        for t, lo, hi in ((bn.weight, 0.5, 1.5), (bn.bias, -0.5, 0.5),
                          (bn.running_mean, -0.5, 0.5),
                          (bn.running_var, 0.5, 2.0)):
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, c).astype(
                np.float32)))
    return bn


def _fold(bn):
    inv = torch.rsqrt(bn.running_var + bn.eps)
    return bn.weight * inv, bn.bias - bn.running_mean * bn.weight * inv


def _z(shape, seed, layout):
    z = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 3, shape).astype(np.float32))
    return z.contiguous(memory_format=layout)


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
def test_plain_equals_bn_then_act(act, layout):
    bn = _bn(24, 1)
    z = _z((2, 24, 7, 9), 2, layout)
    scale, bias = _fold(bn)
    with torch.no_grad():
        want = blocks.get_activation(act)(bn(z))
        got = bn_act_plain(z, scale, bias, act)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert got.dtype == z.dtype and got.stride() == z.stride()
    # bf16: BN's float32 output rounded to bf16 (where BN stored it), the
    # activation in float32, rounded again
    zh = z.bfloat16()
    half = bn_act_plain(zh, scale, bias, act)
    assert half.dtype == torch.bfloat16 and half.stride() == z.stride()
    y = (zh.float() * scale[:, None, None] + bias[:, None, None]).bfloat16()
    assert torch.equal(half, blocks.get_activation(act)(y.float()).bfloat16())


@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
def test_cpu_wrapper_is_the_plain_version(act):
    """On CPU tensors `bn_act` runs the plain version and counts nothing;
    another device raises."""
    z = _z((1, 8, 4, 4), 3, torch.contiguous_format)
    scale, bias = torch.rand(8) + 0.5, torch.randn(8)
    before = bn_act.launches
    assert torch.equal(bn_act(z, scale, bias, act),
                       bn_act_plain(z, scale, bias, act))
    assert bn_act.launches == before
    with pytest.raises(ValueError, match="device"):
        bn_act(z.to("meta"), scale.to("meta"), bias.to("meta"), act)


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
@pytest.mark.parametrize("ksize,stride,groups", [(1, 1, 1), (3, 1, 1),
                                                 (3, 2, 1), (3, 1, 16)])
def test_base_conv_eval_equals_the_unfused_module(ksize, stride, groups, act,
                                                  layout):
    """The epilogue path against conv -> BN -> activation as PyTorch's
    modules run them, depthwise included."""
    m = blocks.BaseConv(16, 16, ksize, stride, groups=groups, act=act)
    m.init_params(np.random.default_rng(4))
    m.bn = _bn(16, 5)
    m.eval()
    x = _z((2, 16, 12, 12), 6, layout)
    with torch.no_grad():
        want = m.act(m.bn(m.conv(x)))
        got = m(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _cfg():
    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.width, cfg.num_classes = 0.125, 3
    cfg.test_size = (SIZE, SIZE)
    return cfg


@pytest.fixture(scope="module")
def module():
    return YoloxModule.from_config(_cfg(), rng_seed=9, device="cpu")


def _frames(seed):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        0, 255, (2, SIZE, SIZE, 3)), dtype=torch.float32)


def _a_conv(module):
    return module.backbone.backbone.dark2[0]


def _unfused_forward(module, x):
    """The module's forward with every BaseConv run unfused: conv, BN and
    the activation as PyTorch's modules."""
    def unfused(self, x):
        return self.act(self.bn(self.conv(x)))

    saved = blocks.BaseConv._forward
    blocks.BaseConv._forward = unfused
    try:
        return module(x)
    finally:
        blocks.BaseConv._forward = saved


@pytest.mark.parametrize("change", ["load_params", "cast_params",
                                    "in_place"])
def test_fold_cache_follows_the_bn_tensors(change):
    """After each change the next eval forward uses the new statistics:
    it equals the unfused module's output on the changed weights."""
    module = YoloxModule.from_config(_cfg(), rng_seed=9, device="cpu")
    x = _frames(1)
    module(x)
    conv = _a_conv(module)
    first = conv._fold_cache
    assert first is not None
    if change == "load_params":
        state = {k: v.clone() for k, v in module.state_dict().items()}
        for k, v in state.items():
            if k.endswith("running_var"):
                v.mul_(3.0)
        module.load_params(state)
        assert conv._fold_cache is None
    elif change == "cast_params":
        module.cast_params(torch.bfloat16)
        assert conv._fold_cache is None
    else:
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, blocks.BaseConv):
                    m.bn.running_mean.add_(0.25)
        assert conv._fold_cache is first  # stale until the next call
    got = module(x)
    assert conv._fold_cache is not first
    assert torch.equal(conv._fold_cache[1][0], conv.bn_fold()[0])
    assert torch.equal(conv._fold_cache[1][1], conv.bn_fold()[1])
    want = _unfused_forward(module, x)
    # bf16: the unfused module rounds after BN and after the activation
    tol = 1e-4 if change != "cast_params" else 0.1
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    again = module(x)
    assert torch.equal(again, got)


def test_fold_is_not_cached_while_autograd_records():
    m = blocks.BaseConv(8, 8, 3, 1, act="silu")
    m.init_params(np.random.default_rng(2))
    m.bn = _bn(8, 3)
    m.eval()
    x = _z((1, 8, 6, 6), 4, torch.contiguous_format)
    m(x).sum().backward()
    assert m._fold_cache is None
    assert m.bn.weight.grad is not None and m.bn.bias.grad is not None
    with torch.no_grad():
        m(x)
    assert m._fold_cache is not None


@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
def test_operator_gradients_are_the_plain_versions(act):
    """`yolox_tpu_torch::bn_act` while autograd records: its output and
    the gradients of z, scale and bias equal `bn_act_plain`'s; an input
    that needs none gets none."""
    bn = _bn(6, 8)
    scale, bias = (t.detach().requires_grad_() for t in _fold(bn))
    z = _z((2, 6, 5, 4), 9, torch.channels_last).requires_grad_()
    y = torch.ops.yolox_tpu_torch.bn_act(z, scale, bias, act)
    want = bn_act_plain(z, scale, bias, act)
    assert torch.equal(y, want)
    g = torch.from_numpy(np.random.default_rng(10).normal(
        size=y.shape).astype(np.float32))
    got = torch.autograd.grad(y, (z, scale, bias), g)
    for a, b in zip(got, torch.autograd.grad(want, (z, scale, bias), g)):
        assert torch.equal(a, b)
    z, bias = z.detach(), bias.detach()
    y = torch.ops.yolox_tpu_torch.bn_act(z, scale, bias, act)
    assert torch.equal(torch.autograd.grad(y.sum(), scale)[0],
                       torch.autograd.grad(bn_act_plain(
                           z, scale, bias, act).sum(), scale)[0])


def test_float_serving_fn_exports_with_the_epilogue(module):
    """One `bn_act` node a BaseConv past the stem (73 in yolox-s), the
    fold computed in the program, and the program equal to the eager
    call bit for bit."""
    x = _frames(2)
    fn = module.make_serving_fn(conf_thre=0.0, max_det=16)
    with torch.no_grad():
        program = torch.export.export(fn, (x,), strict=False)
    counts = exported_ops(program)
    assert counts["bn_act"] == 73
    assert counts["stem_conv_bn_act"] == counts["nms_keep"] == 1
    with torch.inference_mode():
        got = program.module()(x)
        want = fn(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_output_equals_the_real_one(dtype, layout):
    from torch._subclasses.fake_tensor import FakeTensorMode

    z = _z((2, 24, 5, 7), 7, layout).to(dtype)
    scale, bias = torch.rand(24) + 0.5, torch.randn(24)
    real = torch.ops.yolox_tpu_torch.bn_act(z, scale, bias, "silu")
    fake = FakeTensorMode()
    with fake:
        out = torch.ops.yolox_tpu_torch.bn_act(
            fake.from_tensor(z), fake.from_tensor(scale),
            fake.from_tensor(bias), "silu")
    assert (out.shape, out.dtype, out.stride()) == (
        real.shape, real.dtype, real.stride())


def test_silu_and_lrelu_are_the_blocks_activations():
    """`bn_act_plain`'s activations are the blocks' modules'."""
    y = torch.linspace(-100, 100, 2001)
    one, zero = torch.ones(1), torch.zeros(1)
    z = y.view(1, 1, 1, -1)
    assert torch.equal(bn_act_plain(z, one, zero, "silu").flatten(),
                       F.silu(y))
    assert torch.equal(bn_act_plain(z, one, zero, "lrelu").flatten(),
                       blocks.LReLU()(y))
