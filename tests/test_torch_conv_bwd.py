"""The port's fused Conv -> BN -> act Function (`yolox_tpu_torch/ops/
conv_bwd.py`) and the plain versions of its kernels K3 and K4, on the CPU.

- The Function against the JAX package's `fused_conv_bn_act` and against
  torch autograd of conv -> `F.batch_norm(training=True)` -> act: y, mean,
  var and the gradients of x, W, gamma and beta, over the cases of
  `tests/test_fused_conv_bwd.py`. float64 at atol 1e-10 (the same math in
  another order); float32 at rtol / atol 2e-4 (the JAX tests' bound).
- `reduce_sums_plain` / `main_1x1_plain` against the Pallas kernels of
  `yolox_tpu/ops/pallas_conv_bwd.py` in interpret mode (`_reduce_sums`,
  `_main_1x1`) on the same rows, float32 and bfloat16. float32: rtol
  1e-5 / atol 1e-5 (sums of at most a few hundred terms of order 1).
  bfloat16: g_x (a bf16 output) within 2^-7 of |ref| + 2^-8 of max |ref|
  (one rounding of the output, and g_z rounded to bf16 before both
  products may round the other way where the two sigmoids differ in the
  last f32 bit); the f32 sums and g_W at rtol / atol 1e-4 of max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolox_tpu.ops import pallas_conv_bwd as pcb
from yolox_tpu_torch.ops import conv_bwd as cb
from yolox_tpu_torch.ops.stem import activate
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

# (ksize, stride, groups, act, cin, cout): tests/test_fused_conv_bwd.py
CASES = [
    (1, 1, 1, "silu", 16, 32),
    (3, 1, 1, "silu", 16, 24),
    (3, 2, 1, "silu", 16, 32),
    (3, 1, 16, "silu", 16, 16),
    (1, 1, 1, "lrelu", 8, 16),
    (5, 2, 1, "silu", 8, 8),
]


def _inputs(seed, cin, cout, ksize, stride, groups, h=12, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, cin))
    w = rng.standard_normal((ksize, ksize, cin // groups, cout)) * 0.2
    gamma = 1.0 + 0.3 * rng.standard_normal(cout)
    beta = 0.1 * rng.standard_normal(cout)
    oh = -(-h // stride)
    ct = rng.standard_normal((b, oh, oh, cout))
    return x, w, gamma, beta, ct


def _jax(args, ksize, stride, groups, act, dtype):
    x, w, gamma, beta, ct = (jnp.asarray(a, dtype) for a in args)

    def loss(x, w, gamma, beta):
        y, _, _ = pcb.fused_conv_bn_act(ksize, stride, groups, act, x, w,
                                        gamma, beta)
        return jnp.sum(y * ct)

    y, mean, var = pcb.fused_conv_bn_act(ksize, stride, groups, act, x, w,
                                         gamma, beta)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(x, w, gamma, beta)
    return ([np.asarray(y).transpose(0, 3, 1, 2), np.asarray(mean),
             np.asarray(var)],
            [np.asarray(grads[0]).transpose(0, 3, 1, 2),
             np.asarray(grads[1]).transpose(3, 2, 0, 1),
             np.asarray(grads[2]), np.asarray(grads[3])])


def _torch(args, stride, groups, act, dtype, fused):
    x, w, gamma, beta, ct = args
    x = torch.tensor(x.transpose(0, 3, 1, 2), dtype=dtype, requires_grad=True)
    w = torch.tensor(w.transpose(3, 2, 0, 1), dtype=dtype, requires_grad=True)
    gamma = torch.tensor(gamma, dtype=dtype, requires_grad=True)
    beta = torch.tensor(beta, dtype=dtype, requires_grad=True)
    ct = torch.tensor(ct.transpose(0, 3, 1, 2), dtype=dtype)
    if fused:
        y, mean, var = cb.fused_conv_bn_act(x, w, gamma, beta, stride, groups,
                                            act)
    else:
        z = F.conv2d(x, w, None, stride, (w.shape[-1] - 1) // 2, 1, groups)
        y = activate(F.batch_norm(z, None, None, gamma, beta, True, 0.0,
                                  cb.BN_EPS), act)
        mean = var = None
    (y * ct).sum().backward()
    return [y, mean, var], [x.grad, w.grad, gamma.grad, beta.grad]


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("ksize,stride,groups,act,cin,cout", CASES)
def test_fused_function_matches_jax_and_autograd(ksize, stride, groups, act,
                                                 cin, cout, precision):
    args = _inputs(ksize * 10 + stride + groups, cin, cout, ksize, stride,
                   groups)
    f64 = precision == "float64"
    tol = dict(rtol=0, atol=1e-10) if f64 else dict(rtol=2e-4, atol=2e-4)
    with jax.enable_x64(f64):
        want_out, want_g = _jax(args, ksize, stride, groups, act,
                                jnp.float64 if f64 else jnp.float32)
    dtype = torch.float64 if f64 else torch.float32
    got_out, got_g = _torch(args, stride, groups, act, dtype, fused=True)
    ref_out, ref_g = _torch(args, stride, groups, act, dtype, fused=False)
    names = ["y", "mean", "var"]
    for name, g, w in zip(names, got_out, want_out):
        assert g.dtype == dtype, name
        np.testing.assert_allclose(g.detach().numpy(), w, **tol, err_msg=name)
    np.testing.assert_allclose(got_out[0].detach().numpy(),
                               ref_out[0].detach().numpy(), **tol)
    for name, g, w, r in zip(["x", "W", "gamma", "beta"], got_g, want_g,
                             ref_g):
        np.testing.assert_allclose(g.numpy(), w, **tol, err_msg=name)
        np.testing.assert_allclose(g.numpy(), r.numpy(), **tol, err_msg=name)


def test_fused_function_bf16_keeps_f32_master_gradients():
    """bf16 activations with f32 master weights: y is bf16, the batch
    statistics and the weight's gradient f32, as in the JAX composite."""
    x, w, gamma, beta, ct = _inputs(3, 16, 32, 1, 1, 1)
    xt = torch.tensor(x.transpose(0, 3, 1, 2), dtype=torch.bfloat16,
                      requires_grad=True)
    wt = torch.tensor(w.transpose(3, 2, 0, 1), dtype=torch.float32,
                      requires_grad=True)
    y, mean, var = cb.fused_conv_bn_act(
        xt, wt, torch.tensor(gamma, dtype=torch.float32),
        torch.tensor(beta, dtype=torch.float32))
    assert (y.dtype, mean.dtype, var.dtype) == (torch.bfloat16,) + (
        torch.float32,) * 2
    (y.float() * torch.tensor(ct.transpose(0, 3, 1, 2))).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32


def _rows(seed, n, ci, co, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ci)).astype(np.float32)
    w = (rng.uniform(-1, 1, (ci, co)) / np.sqrt(ci)).astype(np.float32)
    z = x @ w
    mean, var = z.mean(0), z.var(0)
    inv = 1.0 / np.sqrt(var + 1e-3)
    gamma = (1.0 + 0.3 * rng.standard_normal(co)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(co)).astype(np.float32)
    gy = rng.standard_normal((n, co)).astype(np.float32)
    if dtype == "bfloat16":
        x, w, z, gy = (np.asarray(jnp.asarray(a, jnp.bfloat16)).astype(
            np.float32) for a in (x, w, z, gy))
    return x, w, z, gy, gamma, beta, mean.astype(np.float32), \
        inv.astype(np.float32)


def _nchw(rows, b, h, dtype):
    """(B*H*W, C) rows in NHWC order -> an NCHW tensor."""
    c = rows.shape[1]
    return torch.from_numpy(np.ascontiguousarray(
        rows.reshape(b, h, h, c).transpose(0, 3, 1, 2))).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,ci,co", [(2, 8, 16, 32), (1, 16, 40, 24),
                                       (4, 4, 128, 64)])
def test_plain_kernels_match_pallas_interpret(monkeypatch, b, h, ci, co,
                                              dtype):
    monkeypatch.setattr(pcb, "_INTERPRET", True)
    n = b * h * h
    x, w, z, gy, gamma, beta, mean, inv = _rows(ci + co, n, ci, co, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    want_s = np.asarray(pcb._reduce_sums(
        jnp.asarray(z, jdt), jnp.asarray(gy, jdt), jnp.asarray(gamma),
        jnp.asarray(beta), jnp.asarray(mean), jnp.asarray(inv)))
    zt, gyt = _nchw(z, b, h, tdt), _nchw(gy, b, h, tdt)
    got_s = cb.reduce_sums(zt, gyt, *(torch.from_numpy(a) for a in
                                      (gamma, beta, mean, inv)))
    s_tol = max(np.abs(want_s).max(), 1.0) * (1e-4 if dtype == "bfloat16"
                                              else 1e-5)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=s_tol)

    s1n, s2n = want_s[0] / n, want_s[1] / n
    rows7 = np.stack([gamma, beta, gamma * inv, s1n, s2n, mean, inv])
    coeff = np.concatenate([rows7, np.zeros((1, co), np.float32)])
    want_gx, want_gw = pcb._main_1x1(
        jnp.asarray(x, jdt), jnp.asarray(z, jdt), jnp.asarray(gy, jdt),
        jnp.asarray(w, jdt), jnp.asarray(coeff))
    want_gx = np.asarray(want_gx.astype(jnp.float32))
    got_gx, got_gw = cb.main_1x1(_nchw(x, b, h, tdt), zt, gyt,
                                 torch.from_numpy(w.T.copy()).to(tdt),
                                 torch.from_numpy(rows7))
    assert got_gx.dtype == tdt and got_gw.dtype == torch.float32
    got_gx = got_gx.float().numpy().transpose(0, 2, 3, 1).reshape(n, ci)
    got_gw = got_gw.numpy().T
    gx_max = np.abs(want_gx).max()
    gw_max = np.abs(np.asarray(want_gw)).max()
    if dtype == "bfloat16":
        assert np.all(np.abs(got_gx - want_gx)
                      <= 2.0 ** -7 * np.abs(want_gx) + 2.0 ** -8 * gx_max)
        np.testing.assert_allclose(got_gw, want_gw, rtol=1e-4,
                                   atol=1e-4 * gw_max)
    else:
        np.testing.assert_allclose(got_gx, want_gx, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_gw, want_gw, rtol=1e-5,
                                   atol=1e-5 * gw_max)


def test_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; on any other device they refuse rather than fall back."""
    x, w, z, gy, gamma, beta, mean, inv = _rows(0, 32, 8, 8, "float32")
    zt, gyt = _nchw(z, 2, 4, torch.float32), _nchw(gy, 2, 4, torch.float32)
    vecs = [torch.from_numpy(a) for a in (gamma, beta, mean, inv)]
    before = (cb.reduce_sums.launches, cb.main_1x1.launches)
    assert torch.equal(cb.reduce_sums(zt, gyt, *vecs),
                       cb.reduce_sums_plain(zt, gyt, *vecs))
    assert (cb.reduce_sums.launches, cb.main_1x1.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        cb.reduce_sums(zt.to("meta"), gyt.to("meta"), *vecs)
    with pytest.raises(ValueError, match="unsupported device"):
        cb.main_1x1(zt.to("meta"), zt, gyt, torch.zeros(8, 8), vecs[0])


# (Ci, Co, H at 640 px): count of the 43 1x1 SiLU convs of yolox-s, read
# from the model with `chip_smoke.kernel_conv_shapes`; H scales with the
# input size (stride 4 to 32), so 480 px and 800 px follow
YOLOX_S_1X1 = {(256, 128, 40): 6, (512, 256, 20): 6, (128, 128, 40): 5,
               (64, 64, 80): 4, (128, 128, 80): 3, (256, 256, 40): 3,
               (64, 32, 160): 2, (128, 64, 80): 2, (256, 256, 20): 2,
               (512, 512, 20): 2, (512, 128, 40): 2, (256, 64, 80): 2,
               (32, 32, 160): 1, (64, 64, 160): 1, (1024, 512, 20): 1,
               (512, 128, 20): 1}


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("size", [640, 480, 800, 416])
def test_launch_plan_covers_every_row_once(size, elt):
    """K3's row ranges and K4's k tiles partition [0, B*HW) at every 1x1
    shape of a yolox-s step; each k tile stays inside one image and every
    split gets work; the grids cover every output tile."""
    assert sum(YOLOX_S_1X1.values()) == 43
    for b in (16, 1):
        for (ci, co, h640) in YOLOX_S_1X1:
            h = h640 * size // 640
            hw = h * h
            p = cb.launch_plan(b, ci, co, hw, elt)
            rows = b * hw
            # K3: ranges of `per` rows, whole 16-byte vectors, none empty
            assert p.k3_per % 8 == 0 and p.k3_blocks * 8 >= co
            assert (p.k3_splits - 1) * p.k3_per < rows <= p.k3_splits * p.k3_per
            # K4 wgrad: tiles of bk positions inside one image
            tpi = -(-hw // p.k4_bk)
            assert p.k4_ntiles == b * tpi
            covered = np.zeros(rows, np.int32)
            for t in range(p.k4_ntiles):
                img, p0 = divmod(t, tpi)
                p0 *= p.k4_bk
                p1 = min(p0 + p.k4_bk, hw)
                assert 0 <= p0 < p1 <= hw and img < b
                covered[img * hw + p0:img * hw + p1] += 1
            assert (covered == 1).all()
            assert (p.k4_splits - 1) * p.k4_tps < p.k4_ntiles \
                <= p.k4_splits * p.k4_tps
            assert p.k4_wgrad_grid == (-(-ci // 128), -(-co // 128),
                                       p.k4_splits)
            # about one wave of wgrad blocks (2 resident on each of 132
            # SMs) unless a split would drop below 8 k tiles
            assert int(np.prod(p.k4_wgrad_grid)) <= 264 or p.k4_splits == 1
            assert p.k4_tps >= 8 or p.k4_splits == 1
            assert p.k4_dgrad_grid == (-(-hw // 128), -(-ci // 128), b)
            # partial sums stay within the scratch the wrapper sizes
            assert p.k4_splits <= max(1, p.k4_ntiles)


@pytest.mark.parametrize("h,elt,offset,want", [
    (20, 2, 0, 8), (40, 4, 0, 4),        # 640 px: 16-byte loads
    (15, 2, 0, 1), (25, 4, 0, 1),        # 480 / 800 px: odd HW
    (30, 2, 0, 1), (30, 4, 0, 4),        # HW 900: a multiple of 4, not 8
    (13, 2, 0, 1), (26, 4, 0, 4),        # 416 px
    (20, 2, 2, 1), (20, 4, 4, 1),        # a view one element into storage
    (20, 2, 800, 8)])                    # a channel slice at channel 1
def test_vector_width_from_shape_and_offset(h, elt, offset, want):
    hw = h * h
    base = 1 << 20
    stride = 3 * hw    # a channel slice of a 3x wider concatenation
    assert cb.vector_width(elt, (hw, stride, 128),
                           (base, base + offset)) == want


def test_reduce_sums_coeff_table_on_cpu():
    """With coeff=True the wrapper returns the sums and `coeff_table` of
    them; the plain path counts no launch."""
    x, w, z, gy, gamma, beta, mean, inv = _rows(1, 32, 8, 8, "float32")
    zt, gyt = _nchw(z, 2, 4, torch.float32), _nchw(gy, 2, 4, torch.float32)
    vecs = [torch.from_numpy(a) for a in (gamma, beta, mean, inv)]
    before = cb.reduce_sums.launches
    s, coeff = cb.reduce_sums(zt, gyt, *vecs, coeff=True)
    assert cb.reduce_sums.launches == before
    assert torch.equal(s, cb.reduce_sums_plain(zt, gyt, *vecs))
    assert coeff.shape == (7, 8)
    torch.testing.assert_close(coeff[2], vecs[0] * vecs[3])
    torch.testing.assert_close(coeff[3:5], s / 32)
    torch.testing.assert_close(coeff[[0, 1, 5, 6]], torch.stack(vecs))
