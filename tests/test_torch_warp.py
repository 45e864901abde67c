"""The port's warp engine (`yolox_tpu_torch/ops/warp.py`) against the JAX
package's (`yolox_tpu/ops/pallas_warp.py`), on the CPU.

Inputs come from seeded numpy and go through both. Tolerances:
- `shear_x_plain` vs `shear_x_reference`, and the fused K5's plain
  version `shear_xy_plain` vs JAX's pass 2 -> transpose -> pass 3: atol
  1e-4 on 0-255 data, with shifts inside and outside [0, k_max]
  (extrapolated values stay below 1024, where a float32 ulp is 6.1e-5;
  XLA may contract the lerp into an FMA);
- the scale pass, the full mosaic warp and the MixUp resample: atol 1e-3
  (float32 products summed in another order);
- the three-pass warp against the port's single-pass `mosaic_warp`: exact
  (1e-2) on an integer translation, 98% of pixels within 3 levels on a
  general affine (interpolation order), as the JAX package's own tests;
- bf16 interpolation products against float32: within 4 levels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolox_tpu.ops import pallas_warp as jw
from yolox_tpu_torch.data.device_augment import mosaic_warp
from yolox_tpu_torch.ops import warp as tw
from yolox_tpu_torch.ops.shear_kernel import shear_x, shear_xy
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("px", [1, 3])
def test_shear_plain_matches_reference(px):
    rng = np.random.default_rng(px)
    b, h, w, out_w = 2, 24, 48, 30
    k_max = w - out_w - 2
    img = rng.uniform(0, 255, (b, h, w * px)).astype(np.float32)
    shifts = np.concatenate([
        rng.uniform(0, k_max, (b, h - 8)),                # inside
        np.full((b, 2), float(k_max)),                    # last window
        rng.uniform(-1.5, -0.01, (b, 2)),                 # below 0
        rng.uniform(k_max + 1.01, k_max + 2.5, (b, 2)),   # above k_max + 1
        np.floor(rng.uniform(0, k_max, (b, 2))),          # f = 0
    ], 1).astype(np.float32)
    want = np.asarray(jw.shear_x_reference(jnp.asarray(img),
                                           jnp.asarray(shifts), out_w, px))
    got = tw.shear_x_plain(_t(img), _t(shifts), out_w, px)
    assert got.shape == (b, h, out_w * px) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the wrapper takes the plain version for CPU tensors, counting nothing
    before = shear_x.launches
    assert torch.equal(shear_x(_t(img), _t(shifts), out_w, px), got)
    assert shear_x.launches == before
    # bf16 in, bf16 out, the lerp in float32
    got16 = tw.shear_x_plain(_t(img).bfloat16(), _t(shifts), out_w, px)
    want16 = tw.shear_x_plain(_t(img).bfloat16().float(), _t(shifts), out_w,
                              px).bfloat16()
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, want16)


def _xy_shifts(rng, kind, b, x, r, s):
    """shifts_y (b, x), shifts_x (b, s) float32: as the warp gives them
    (affine, inside both clamps), without a slope bound and up to half a
    pixel past both clamps (random), or at the contract's edges
    (`chip_smoke.shear_edge_shifts`)."""
    from chip_smoke import shear_edge_shifts

    k2, k3 = r - s - 2, x - s - 2
    if kind == "affine":
        a = rng.uniform(-1, 1, (2, b, 1))
        return ((k2 / 2 + a[0] * (k2 / 2 - 1) * (2 * np.arange(x) / x - 1))
                .astype(np.float32),
                (k3 / 2 + a[1] * (k3 / 2 - 1) * (2 * np.arange(s) / s - 1))
                .astype(np.float32))
    if kind == "random":
        return (rng.uniform(-0.5, k2 + 1.5, (b, x)).astype(np.float32),
                rng.uniform(-0.5, k3 + 1.5, (b, s)).astype(np.float32))
    return shear_edge_shifts(b, x, k2), shear_edge_shifts(b, s, k3)


@pytest.mark.parametrize("kind", ["affine", "random", "edge"])
def test_shear_xy_plain_matches_jax_composition(kind):
    """The fused K5's plain version against JAX's warp passes 2 and 3
    (`pallas_warp.py:mosaic_affine_warp`): shear_x_reference, transpose,
    shear_x_reference, at px 3 on a non-square h1t."""
    rng = np.random.default_rng(["affine", "random", "edge"].index(kind))
    b, x, r, s, px = 2, 40, 36, 24, 3
    img = rng.uniform(0, 255, (b, x, r * px)).astype(np.float32)
    sy, sx = _xy_shifts(rng, kind, b, x, r, s)
    h2 = jw.shear_x_reference(jnp.asarray(img), jnp.asarray(sy), s, px)
    h2t = jnp.transpose(h2.reshape(b, x, s, px), (0, 2, 1, 3)).reshape(
        b, s, x * px)
    want = np.asarray(jw.shear_x_reference(h2t, jnp.asarray(sx), s, px))
    got = tw.shear_xy_plain(_t(img), _t(sy), _t(sx), s, px)
    assert got.shape == (b, s, s * px) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the wrapper takes the plain version for CPU tensors, counting nothing
    before = (shear_xy.launches, shear_x.launches)
    assert torch.equal(shear_xy(_t(img), _t(sy), _t(sx), s, px), got)
    assert (shear_xy.launches, shear_x.launches) == before
    # bf16: h2 rounded to bf16 between the passes, each lerp in float32
    img16 = _t(img).bfloat16()
    h2_16 = tw.shear_x_plain(img16, _t(sy), s, px)
    assert h2_16.dtype == torch.bfloat16
    want16 = tw.shear_x_plain(h2_16.reshape(b, x, s, px).transpose(1, 2)
                              .reshape(b, s, x * px), _t(sx), s, px)
    assert torch.equal(tw.shear_xy_plain(img16, _t(sy), _t(sx), s, px),
                       want16)


def test_shear_xy_rejects_what_it_does_not_take():
    img = torch.zeros((2, 12, 30))
    sy, sx = torch.zeros((2, 12)), torch.zeros((2, 8))
    assert shear_xy(img, sy, sx, 8, px=3).shape == (2, 8, 24)
    with pytest.raises(ValueError, match="out_w"):
        shear_xy(img, sy, torch.zeros((2, 9)), 9, px=3)  # R 10 < 9 + 2
    with pytest.raises(ValueError, match="shifts_y"):
        shear_xy(img, sy[:, :5], sx, 8, px=3)
    with pytest.raises(ValueError, match="shifts_x"):
        shear_xy(img, sy, sx[:1], 8, px=3)
    with pytest.raises(ValueError, match="px"):
        shear_xy(img, sy, sx, 8, px=4)
    with pytest.raises(ValueError, match="device"):
        shear_xy(img.to("meta"), sy.to("meta"), sx.to("meta"), 8, px=3)


def test_shear_rejects_what_it_does_not_take():
    img = torch.zeros((1, 4, 30))
    with pytest.raises(ValueError, match="out_w"):
        shear_x(img, torch.zeros((1, 4)), 9, px=3)      # W 10 < 9 + 2
    with pytest.raises(ValueError, match="shifts"):
        shear_x(img, torch.zeros((1, 5)), 4, px=3)
    with pytest.raises(ValueError, match="px"):
        shear_x(img, torch.zeros((1, 4)), 4, px=4)
    with pytest.raises(ValueError, match="device"):
        shear_x(img.to("meta"), torch.zeros((1, 4), device="meta"), 4, px=3)


def test_margins_and_decompositions_match_jax():
    for s in (64, 96, 416, 640):
        assert tw.default_margin(s) == jw.default_margin(s)
        for deg, sh in ((10.0, 2.0), (0.0, 0.0), (20.0, 5.0)):
            assert tw.margin_for(s, deg, sh) == jw.margin_for(s, deg, sh)
    with pytest.raises(ValueError):
        tw.margin_for_slope(640, 0.9)
    rng = np.random.default_rng(0)
    m = np.concatenate([rng.uniform(0.6, 1.4, (5, 2, 2)) * np.eye(2)
                        + rng.uniform(-0.2, 0.2, (5, 2, 2)),
                        rng.uniform(-50, 50, (5, 2, 1))],
                       -1).astype(np.float32)
    minv, tinv = tw.affine_inverse_2x3(_t(m))
    want = [jw.affine_inverse_2x3(jnp.asarray(mi)) for mi in m]
    np.testing.assert_allclose(minv.numpy(), np.stack([np.asarray(w[0])
                                                       for w in want]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tinv.numpy(), np.stack([np.asarray(w[1])
                                                       for w in want]),
                               rtol=1e-6, atol=1e-5)
    got = tw.ldu_decompose(minv)
    for i, mi in enumerate(minv.numpy()):
        for g, w in zip(got, jw.ldu_decompose(jnp.asarray(mi))):
            np.testing.assert_allclose(float(g[i]), float(w), rtol=1e-6,
                                       atol=1e-7)
    p, q, cl, uu = (v[:, None, None] for v in got)
    one, zero = torch.ones_like(p), torch.zeros_like(p)

    def mat(a, b, c, d):
        return torch.cat([torch.cat([a, b], 2), torch.cat([c, d], 2)], 1)

    prod = (mat(p, zero, zero, q) @ mat(one, zero, cl, one)
            @ mat(one, uu, zero, one))
    np.testing.assert_allclose(prod.numpy(), minv.numpy(), atol=1e-6)


def _tiles(rng, b, n, t, lo=16):
    tiles = rng.integers(0, 255, (b, n, t, t, 3), dtype=np.uint8)
    hw = rng.integers(lo, t + 1, (b, n, 2)).astype(np.float32)
    return tiles, hw


@pytest.mark.parametrize("transposed_out", [False, True])
@pytest.mark.parametrize("zero_outside_canvas", [False, True])
def test_scale_resample_tiles_matches_jax(zero_outside_canvas,
                                          transposed_out):
    rng = np.random.default_rng(int(zero_outside_canvas) + 2)
    b, n, t = 2, 4, 64
    tiles, hw = _tiles(rng, b, n, t)
    offsets = rng.uniform(-10, 70, (b, n, 2)).round().astype(np.float32)
    xs = np.stack([np.linspace(-7.3, 140.0, 72),
                   np.linspace(3.1, 120.0, 72)]).astype(np.float32)
    ys = np.stack([np.linspace(-4.6, 131.0, 80),
                   np.linspace(-9.0, 100.5, 80)]).astype(np.float32)
    canvas = (128.0, 120.0)
    want = np.asarray(jax.vmap(
        lambda ti, h, o, x, y: jw.scale_resample_tiles(
            ti, h, o, x, y, canvas, zero_outside_canvas=zero_outside_canvas,
            transposed_out=transposed_out))(
        *map(jnp.asarray, (tiles, hw, offsets, xs, ys))))
    got = tw.scale_resample_tiles(
        *map(_t, (tiles, hw, offsets, xs, ys)), canvas,
        zero_outside_canvas=zero_outside_canvas,
        transposed_out=transposed_out)
    assert got.shape == want.shape == ((b, 72, 80, 3) if transposed_out
                                       else (b, 80, 72, 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # canvas sizes per sample, as the MixUp resample passes them
    got_b = tw.scale_resample_tiles(
        *map(_t, (tiles, hw, offsets, xs, ys)),
        (torch.full((b,), canvas[0]), torch.full((b,), canvas[1])),
        zero_outside_canvas=zero_outside_canvas,
        transposed_out=transposed_out)
    assert torch.equal(got_b, got)


def _affines(rng, b, s):
    out = []
    for _ in range(b):
        ang = np.deg2rad(rng.uniform(-10, 10))
        sc = rng.uniform(0.6, 1.6)
        shx, shy = np.tan(np.deg2rad(rng.uniform(-2, 2, 2)))
        r0 = np.array([np.cos(ang), np.sin(ang)]) * sc
        r1 = np.array([-np.sin(ang), np.cos(ang)]) * sc
        t = rng.uniform(-0.1, 0.1, 2) * s - s / 2 * sc
        out.append([[*(r0 + shy * r1), t[0]], [*(r1 + shx * r0), t[1]]])
    return np.asarray(out, np.float32)


def test_mosaic_affine_warp_matches_jax():
    s, b = 64, 2
    rng = np.random.default_rng(4)
    tiles, hw = _tiles(rng, b, 4, s, lo=24)
    m = _affines(rng, b, s)
    xc = np.floor(rng.uniform(0.5 * s, 1.5 * s, b)).astype(np.float32)
    yc = np.floor(rng.uniform(0.5 * s, 1.5 * s, b)).astype(np.float32)
    want = np.asarray(jw.mosaic_affine_warp(
        *map(jnp.asarray, (tiles, hw, m, xc, yc)), (s, s)))
    got = tw.mosaic_affine_warp(*map(_t, (tiles, hw, m, xc, yc)), (s, s))
    assert got.shape == (b, s, s, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # a margin for wider ranges keeps the result (the slack only grows)
    wide = tw.mosaic_affine_warp(*map(_t, (tiles, hw, m, xc, yc)), (s, s),
                                 margin=tw.margin_for(s, 20.0, 5.0))
    np.testing.assert_allclose(wide.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("flips", [(False, False), (True, True),
                                   (True, False)])
def test_mixup_resample_matches_jax(flips):
    s, b = 64, 2
    rng = np.random.default_rng(6)
    tiles, hw = _tiles(rng, b, 1, s, lo=20)
    tiles, hw = tiles[:, 0], hw[:, 0]
    r0 = np.minimum(s / hw[:, 0], s / hw[:, 1])
    r = (r0 * np.array([1.3, 0.7])).astype(np.float32)
    x_off = np.array([4.0, 0.0], np.float32)
    y_off = np.array([2.0, 0.0], np.float32)
    want = np.stack([np.asarray(jw.mixup_resample(
        jnp.asarray(tiles[i]), jnp.asarray(hw[i]), jnp.float32(r[i]),
        flips[0], jnp.float32(x_off[i]), jnp.float32(y_off[i]), (s, s),
        out_flip=flips[1])) for i in range(b)])
    got = tw.mixup_resample(
        _t(tiles), _t(hw), _t(r), torch.tensor([flips[0]] * b), _t(x_off),
        _t(y_off), (s, s), out_flip=torch.tensor([flips[1]] * b))
    assert got.shape == (b, s, s, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_mosaic_affine_warp_exact_on_integer_transform():
    """Integer pure translation: the three passes are exact against the
    single-pass gather warp."""
    s = 64
    rng = np.random.default_rng(2)
    tiles = np.zeros((1, 4, s, s, 3), np.uint8)
    hw = np.zeros((1, 4, 2), np.float32)
    for t in range(4):
        h, w = (int(v) for v in rng.integers(40, s + 1, 2))
        tiles[0, t, :h, :w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        hw[0, t] = (h, w)
    xc, yc = 70.0, 58.0
    m = np.array([[1.0, 0.0, -17.0], [0.0, 1.0, -23.0]], np.float32)
    got = tw.mosaic_affine_warp(_t(tiles), _t(hw), _t(m)[None],
                                torch.tensor([xc]), torch.tensor([yc]),
                                (s, s))[0]
    want = mosaic_warp(_t(tiles[0]), _t(hw[0]), _t(m), xc, yc, (s, s))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-2)


def test_mosaic_affine_warp_close_on_general_affine():
    """Rotation, scale and shear on a canvas that is one smooth gradient:
    the three passes and the single pass agree but at the frontier."""
    s = 64
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    tiles = np.zeros((1, 4, s, s, 3), np.uint8)
    for t, (ox, oy) in enumerate([(0, 0), (64, 0), (0, 64), (64, 64)]):
        cx_, cy_ = xx + ox, yy + oy
        tiles[0, t] = np.stack([cx_ * 1.5, cy_ * 1.5, (cx_ + cy_) * 0.75],
                               -1).astype(np.uint8)
    hw = np.full((1, 4, 2), s, np.float32)
    ang, sc = np.deg2rad(8.0), 1.3
    m = np.array([[np.cos(ang) * sc, np.sin(ang) * sc, -40.0],
                  [-np.sin(ang) * sc, np.cos(ang) * sc, -30.0]], np.float32)
    got = tw.mosaic_affine_warp(_t(tiles), _t(hw), _t(m)[None],
                                torch.tensor([64.0]), torch.tensor([64.0]),
                                (s, s))[0]
    want = mosaic_warp(_t(tiles[0]), _t(hw[0]), _t(m), 64.0, 64.0, (s, s))
    close = (got - want).abs() <= 3.0
    assert close.float().mean() > 0.98, close.float().mean()


def test_bf16_resample_deviation_bounded(monkeypatch):
    """bf16 interpolation products (the card's compute dtype) stay within
    4 levels of float32: pixel values are exact in bf16, the weights round
    to ~2^-9 relative, and the products accumulate in float32."""
    rng = np.random.default_rng(7)
    t = 64
    tiles, hw = _tiles(rng, 1, 4, t, lo=32)
    offsets = rng.uniform(0, 40, (1, 4, 2)).round().astype(np.float32)
    xs = np.linspace(-5.0, 120.0, 96, dtype=np.float32)[None]
    ys = np.linspace(-3.0, 110.0, 96, dtype=np.float32)[None]
    out = {dt: tw.scale_resample_tiles(
        *map(_t, (tiles, hw, offsets, xs, ys)), (128, 128),
        compute_dtype=dt) for dt in (torch.float32, torch.bfloat16)}
    assert (out[torch.float32] - out[torch.bfloat16]).abs().max() <= 4.0

    # the MixUp resample takes the device's compute dtype: force bf16
    def call():
        return tw.mixup_resample(
            _t(tiles[:, 0]), _t(hw[:, 0]), torch.tensor([1.3]),
            torch.tensor([flip]), torch.tensor([4.0]), torch.tensor([2.0]),
            (96, 96), out_flip=flip)

    for flip in (False, True):
        f32 = call()
        with monkeypatch.context() as mp:
            mp.setattr(tw, "compute_dtype_for", lambda dev: torch.bfloat16)
            b16 = call()
        assert (f32 - b16).abs().max() <= 4.0


def test_bf16_mosaic_warp_deviation_bounded(monkeypatch):
    """The whole three-pass warp with the card's bf16 products and
    buffers: at most 8 bf16 roundings of values below 256 reach a pixel
    (0.5 each), so it stays within 4 levels of float32 (the limit
    `chip_smoke.AUG_IMG_TOL` holds the card to against the CPU)."""
    s, b = 64, 4
    rng = np.random.default_rng(8)
    tiles, hw = _tiles(rng, b, 4, s, lo=24)
    args = [_t(a) for a in (tiles, hw, _affines(rng, b, s),
                            np.floor(rng.uniform(32, 96, b)).astype(
                                np.float32),
                            np.floor(rng.uniform(32, 96, b)).astype(
                                np.float32))]
    f32 = tw.mosaic_affine_warp(*args, (s, s))
    monkeypatch.setattr(tw, "compute_dtype_for", lambda dev: torch.bfloat16)
    b16 = tw.mosaic_affine_warp(*args, (s, s))
    dev = (f32 - b16).abs()
    assert 0 < dev.max() <= 4.0 and dev.mean() < 0.5
