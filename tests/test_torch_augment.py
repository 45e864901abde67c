"""The port's device augmentation (`yolox_tpu_torch/data/device_augment.py`)
and augmented training steps against the JAX package's, on the CPU.

- `augment_with_draws` fed the draws that JAX's `device_augment_batch`
  takes from a key (rebuilt here with the same split tree) equals JAX's
  result: images within 1e-2 on the 0-255 scale (float32 products summed
  in another order, through HSV), labels within 1e-3, and the rows' order
  and padding exact.
- The label and HSV pieces against JAX on the same inputs; hue values at
  the sextant edges and across the 180 wrap.
- `sample_augment_draws` against JAX's sampler in distribution (the
  streams differ): two-sample KS tests on 4096 draws of each continuous
  variable, binomial tests on the flags, p > 1e-3.
- Properties of the JAX package's own tests, on the port: labels sit on
  content, the same generator state gives the same batch, the folded flip
  is a mirror, the static fast paths equal the generic path.
- `make_augmented_train_step` equals `device_augment_batch` followed by
  `make_train_step`, with and without the multiscale resize;
  `_multiscale_resize` matches JAX's within 1e-3 on 0-255 data;
  `make_pipelined_train_step` follows the serial step's trajectory. All on
  a small YOLOX (depth 0.33, width 0.125, 8 classes) at 64 px; no JAX
  train step is compiled here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from yolox_tpu.core.train_step import _multiscale_resize as j_resize
from yolox_tpu.data import device_augment as jd
from yolox_tpu_torch import YoloxConfig, YoloxModule
from yolox_tpu_torch.core import (
    init_train_state,
    make_augmented_train_step,
    make_pipelined_train_step,
    make_train_step,
)
from yolox_tpu_torch.core.train_step import _multiscale_resize
from yolox_tpu_torch.data import device_augment as td
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

DRAW_KEYS = ("yc", "xc", "m", "u_mix", "jf", "mixflip", "y_off", "x_off",
             "do_mosaic", "do_hsv", "do_flip", "hsv_gains")


def jax_draws(key, b, out_size, degrees=10.0, translate=0.1,
              scales=(0.1, 2.0), mixup_scale=(0.5, 1.5), shear=2.0,
              flip_prob=0.5, hsv_prob=1.0, mosaic_prob=1.0, hgain=5.0,
              sgain=30.0, vgain=30.0):
    """The per-sample draws of JAX's `device_augment_batch(key)`
    (`device_augment.py:428-455`) and the HSV gains `hsv_jitter` takes
    from its key (lines 303-306), as torch tensors."""
    oh, ow = out_size

    def draws(k):
        ks = jax.random.split(k, 10)
        yc = jnp.floor(jax.random.uniform(ks[0], (), minval=0.5 * oh,
                                          maxval=1.5 * oh))
        xc = jnp.floor(jax.random.uniform(ks[1], (), minval=0.5 * ow,
                                          maxval=1.5 * ow))
        m, _ = jd.random_affine_matrix(ks[2], out_size, degrees, translate,
                                       scales, shear)
        u_mix = jax.random.uniform(ks[3], ())
        jf = jax.random.uniform(ks[4], (), minval=mixup_scale[0],
                                maxval=mixup_scale[1])
        mixflip = jax.random.uniform(ks[5], ()) > 0.5
        y_off = jnp.floor(jax.random.uniform(ks[6], ())
                          * jnp.maximum(oh * jf - oh, 0.0))
        x_off = jnp.floor(jax.random.uniform(ks[7], ())
                          * jnp.maximum(ow * jf - ow, 0.0))
        do_mosaic = jax.random.uniform(ks[8], ()) < mosaic_prob
        sub = jax.random.split(ks[9], 3)
        do_hsv = jax.random.uniform(sub[0], ()) < hsv_prob
        do_flip = jax.random.uniform(sub[1], ()) < flip_prob
        hk = jax.random.split(sub[2], 2)
        gains = jax.random.uniform(hk[0], (3,), minval=-1.0, maxval=1.0) \
            * jnp.asarray([hgain, sgain, vgain])
        gains = gains * jax.random.bernoulli(hk[1], 0.5, (3,))
        return (yc, xc, m, u_mix, jf, mixflip, y_off, x_off, do_mosaic,
                do_hsv, do_flip, gains)

    out = jax.vmap(draws)(jax.random.split(key, b))
    return {k: torch.from_numpy(np.array(v)) for k, v in zip(DRAW_KEYS, out)}


def _batch(seed, b, s, n_labels=6):
    """Tiles of random sizes with random content and 0-3 boxes each."""
    rng = np.random.default_rng(seed)
    tiles = np.zeros((b, 5, s, s, 3), np.uint8)
    hw = np.zeros((b, 5, 2), np.float32)
    labels = np.zeros((b, 5, n_labels, 5), np.float32)
    for bi in range(b):
        for ti in range(5):
            h, w = (int(v) for v in rng.integers(s // 2, s + 1, 2))
            tiles[bi, ti, :h, :w] = rng.integers(0, 255, (h, w, 3),
                                                 dtype=np.uint8)
            hw[bi, ti] = (h, w)
            for li in range(int(rng.integers(0 if ti < 4 else 1, 4))):
                x1, y1 = rng.uniform(0, w - 10), rng.uniform(0, h - 10)
                labels[bi, ti, li] = [x1, y1, rng.uniform(x1 + 4, w),
                                      rng.uniform(y1 + 4, h),
                                      rng.integers(0, 80)]
    return tiles, hw, labels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (out size, device_augment_batch settings): mosaic 1.0 and 0.5, MixUp on
# and off (and gated at 0.5), HSV on, off and at 0.5, flip 0, 0.5 and 1
SETTINGS = [
    (64, {}),
    (96, dict(mosaic_prob=0.5, hsv_prob=0.5, flip_prob=1.0, mixup_prob=0.5)),
    (64, dict(enable_mixup=False, hsv_prob=0.0, flip_prob=0.0)),
    (96, dict(flip_prob=0.0, scales=(0.5, 1.5))),
    (64, dict(mosaic_prob=0.5, enable_mixup=False, flip_prob=1.0)),
]


@pytest.mark.parametrize("s,kw", SETTINGS)
def test_augment_with_jax_draws_matches_jax(s, kw):
    b = 3
    tiles, hw, labels = _batch(s, b, s)
    key = jax.random.PRNGKey(s + len(kw))
    want_img, want_lab = jd.device_augment_batch(
        jnp.asarray(tiles), jnp.asarray(hw), jnp.asarray(labels), key,
        out_size=(s, s), max_labels=24, **kw)
    want_img, want_lab = np.asarray(want_img), np.asarray(want_lab)
    draws = jax_draws(key, b, (s, s), **{
        k: v for k, v in kw.items()
        if k in ("flip_prob", "hsv_prob", "mosaic_prob", "scales")})
    img, lab = td.augment_with_draws(
        _t(tiles), _t(hw), _t(labels), draws, out_size=(s, s),
        max_labels=24, **{k: v for k, v in kw.items()
                          if k in ("enable_mixup", "hsv_prob",
                                   "mosaic_prob", "mixup_prob")})
    assert img.shape == (b, s, s, 3) and img.dtype == torch.float32
    assert lab.shape == (b, 24, 5) and lab.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), want_img, rtol=0, atol=1e-2)
    np.testing.assert_array_equal((lab.numpy() != 0).any(-1),
                                  (want_lab != 0).any(-1))
    np.testing.assert_allclose(lab.numpy(), want_lab, rtol=0, atol=1e-3)
    assert (want_lab != 0).any(-1).sum() > 0


def test_warp_affine_matches_jax():
    """The single-pass gather warp (the oracle of the three passes)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    for seed in range(3):
        m = np.array(jd.random_affine_matrix(
            jax.random.PRNGKey(seed), (80, 96), degrees=30.0,
            scales=(0.5, 1.5))[0])
        m[:, 2] += rng.uniform(-30, 30, 2)
        want = np.asarray(jd.warp_affine(jnp.asarray(img), jnp.asarray(m),
                                         (80, 96)))
        got = td.warp_affine(_t(img), _t(m), (80, 96))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_mosaic_geometry_and_label_transforms_match_jax():
    rng = np.random.default_rng(1)
    b, s, n = 6, 64, 5
    hw = rng.integers(16, s + 1, (b, 4, 2)).astype(np.float32)
    xc = np.floor(rng.uniform(0.5 * s, 1.5 * s, b)).astype(np.float32)
    yc = np.floor(rng.uniform(0.5 * s, 1.5 * s, b)).astype(np.float32)
    paste, offset = td._mosaic_geometry(_t(hw), _t(xc), _t(yc), float(s),
                                        float(s))
    w_paste, w_offset = jax.vmap(lambda h, x, y: jd._mosaic_geometry(
        h, x, y, float(s), float(s)))(*map(jnp.asarray, (hw, xc, yc)))
    np.testing.assert_array_equal(paste.numpy(), np.asarray(w_paste))
    np.testing.assert_array_equal(offset.numpy(), np.asarray(w_offset))
    p1, o1 = td._mosaic_geometry(_t(hw[0]), float(xc[0]), float(yc[0]),
                                 float(s), float(s))  # one sample
    assert torch.equal(p1, paste[0]) and torch.equal(o1, offset[0])

    labels = np.zeros((b, 4, n, 5), np.float32)
    x1y1 = rng.uniform(-5, 50, (b, 4, n, 2))
    labels[..., :2] = x1y1
    labels[..., 2:4] = x1y1 + rng.uniform(0.5, 30, (b, 4, n, 2))
    labels[..., 4] = rng.integers(0, 80, (b, 4, n))
    valid = rng.random((b, 4, n)) < 0.8
    sp = np.concatenate([rng.uniform(0.5, 1.5, (b, 4, 1)),
                         offset.numpy()], -1).astype(np.float32)
    m = np.stack([np.asarray(jd.random_affine_matrix(
        jax.random.PRNGKey(i), (s, s), scales=(0.5, 1.5))[0])
        for i in range(b)])
    boxes, keep = td.transform_labels(*map(_t, (labels, valid, sp, m)),
                                      (s, s))
    w_boxes, w_keep = jax.vmap(lambda *a: jd.transform_labels(*a, (s, s)))(
        *map(jnp.asarray, (labels, valid, sp, m)))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(w_keep))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(w_boxes), atol=1e-4)
    assert 0 < keep.sum() < keep.numel()

    r = rng.uniform(0.3, 2.0, b).astype(np.float32)
    jf = rng.uniform(0.5, 1.5, b).astype(np.float32)
    flip = rng.random(b) < 0.5
    xo = np.floor(rng.uniform(0, 20, b)).astype(np.float32)
    yo = np.floor(rng.uniform(0, 20, b)).astype(np.float32)
    args = (labels[:, 0], valid[:, 0], r, flip, xo, yo, s * jf, s * jf)
    got = td._mixup_labels(*map(_t, args), (s, s))
    want = jax.vmap(lambda *a: jd._mixup_labels(*a, (s, s)))(
        *map(jnp.asarray, args))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)

    rows = np.concatenate([boxes.numpy(), got[0].numpy()], 1)
    kept = np.concatenate([keep.numpy(), got[1].numpy()], 1)
    for max_labels in (8, 64):
        packed = td._pack_labels(_t(rows), _t(kept), max_labels)
        w_packed = jax.vmap(lambda r_, k_: jd._pack_labels(
            r_, k_, max_labels))(jnp.asarray(rows), jnp.asarray(kept))
        np.testing.assert_allclose(packed.numpy(), np.asarray(w_packed),
                                   rtol=0, atol=1e-5)


def test_hsv_jitter_matches_jax_at_sextant_edges():
    """Hue at every sextant edge (two channels equal at the max or the
    min), near 0 and 180, grays, black and white; gains from JAX keys."""
    rng = np.random.default_rng(2)
    v = rng.uniform(1, 255, 512).astype(np.float32)
    lo = v * rng.uniform(0, 1, 512).astype(np.float32)
    mid = lo + (v - lo) * rng.uniform(0, 1, 512).astype(np.float32)
    tiny = v - np.float32(1e-3)
    pix = np.concatenate([
        np.stack([v, v, lo], -1), np.stack([v, lo, v], -1),     # r=g, r=b max
        np.stack([lo, v, v], -1), np.stack([v, lo, lo], -1),    # g=b max, min
        np.stack([lo, v, lo], -1), np.stack([lo, lo, v], -1),
        np.stack([v, lo, tiny], -1),                            # h ~ 180
        np.stack([v, tiny, lo], -1),                            # h ~ 60
        np.stack([v, mid, lo], -1), np.stack([mid, lo, v], -1),
        np.stack([v, v, v], -1),
        np.array([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 1e-7]],
                 np.float32)], 0)
    n = 8
    pix = np.resize(pix, (n, 24, 32, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    want = np.asarray(jax.vmap(jd.hsv_jitter)(jnp.asarray(pix), keys))
    gains = np.stack([np.asarray(
        jax.random.uniform(jax.random.split(k, 2)[0], (3,), minval=-1.0,
                           maxval=1.0) * jnp.asarray([5.0, 30.0, 30.0])
        * jax.random.bernoulli(jax.random.split(k, 2)[1], 0.5, (3,)))
        for k in keys])
    assert (gains[:, 0] != 0).sum() >= 2
    got = td.hsv_jitter(_t(pix), _t(gains))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # bf16 in, bf16 out, the math in float32
    got16 = td.hsv_jitter(_t(pix).bfloat16(), _t(gains))
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, td.hsv_jitter(_t(pix).bfloat16().float(),
                                            _t(gains)).bfloat16())
    # both frameworks round gains half to even, and take the float modulo
    # with the divisor's sign
    half = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(_t(half)).numpy(),
                                  np.asarray(jnp.round(half)))
    x = np.array([-1e-7, -6.0, -5.9999995, 5.9999995, 180.0, -0.0, 359.99997],
                 np.float32)
    for d in (6.0, 180.0):
        np.testing.assert_array_equal(torch.remainder(_t(x), d).numpy(),
                                      np.asarray(jnp.asarray(x) % d))


def test_sampler_matches_jax_in_distribution():
    n, s = 4096, 640
    kw = dict(flip_prob=0.5, hsv_prob=0.3, mosaic_prob=0.7)
    want = jax_draws(jax.random.PRNGKey(0), n, (s, s), **kw)
    got = td.sample_augment_draws(n, torch.Generator().manual_seed(0),
                                  (s, s), **kw)
    assert set(got) == set(DRAW_KEYS)
    for k in DRAW_KEYS:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        g, w = got[k].reshape(n, -1).numpy(), want[k].reshape(n, -1).numpy()
        for c in range(g.shape[1]):
            if g.dtype == np.bool_:
                p = {"mixflip": 0.5, "do_mosaic": 0.7, "do_hsv": 0.3,
                     "do_flip": 0.5}[k]
                assert stats.binomtest(int(g[:, c].sum()), n, p).pvalue > 1e-3
                assert stats.binomtest(int(w[:, c].sum()), n, p).pvalue > 1e-3
            else:
                assert stats.ks_2samp(g[:, c], w[:, c]).pvalue > 1e-3, (k, c)
    assert (got["yc"] == torch.floor(got["yc"])).all()


def test_labels_sit_on_content():
    """Every returned box lies on real (non-pad) content."""
    s, b = 96, 4
    rng = np.random.default_rng(3)
    tiles = np.zeros((b, 5, s, s, 3), np.uint8)
    hw = np.zeros((b, 5, 2), np.float32)
    labels = np.zeros((b, 5, 8, 5), np.float32)
    for bi in range(b):
        for ti in range(5):
            h, w = (int(v) for v in rng.integers(48, s + 1, 2))
            tiles[bi, ti, :h, :w] = rng.integers(60, 255, (h, w, 3),
                                                 dtype=np.uint8)
            hw[bi, ti] = (h, w)
            labels[bi, ti, 0] = [8.0, 8.0, w - 8.0, h - 8.0,
                                 float(rng.integers(0, 80))]
    imgs, out = td.device_augment_batch(
        _t(tiles), _t(hw), _t(labels), torch.Generator().manual_seed(0),
        out_size=(s, s), max_labels=16)
    imgs, out = imgs.numpy(), out.numpy()
    assert imgs.shape == (b, s, s, 3) and out.shape == (b, 16, 5)
    assert np.isfinite(imgs).all() and (imgs >= 0).all() \
        and (imgs <= 255).all()
    n_with_labels = 0
    for bi in range(b):
        live = out[bi][np.abs(out[bi]).sum(1) > 0]
        n_with_labels += bool(len(live))
        for cls, cx, cy, w, h in live:
            assert 0 <= cx <= s and 0 <= cy <= s and w > 1 and h > 1
            x1, x2 = int(max(cx - w / 2, 0)), int(min(cx + w / 2, s))
            y1, y2 = int(max(cy - h / 2, 0)), int(min(cy + h / 2, s))
            region = imgs[bi, y1:y2, x1:x2]
            assert (np.abs(region - 114.0) > 5).mean() > 0.1, (bi, cls)
    assert n_with_labels >= b // 2


def test_same_generator_state_same_batch():
    s = 64
    tiles, hw, labels = _batch(5, 2, s)
    args = (_t(tiles), _t(hw), _t(labels))

    def run(seed):
        return td.device_augment_batch(
            *args, torch.Generator().manual_seed(seed), out_size=(s, s),
            max_labels=8)

    a1, l1 = run(7)
    a2, l2 = run(7)
    assert torch.equal(a1, a2) and torch.equal(l1, l2)
    a3, _ = run(8)
    assert not torch.equal(a1, a3)


def test_folded_flip_is_a_mirror():
    """The plain path mirrors bit-exactly and labels mirror exactly
    (ow - x); the mosaic path mirrors up to the passes' interpolation. The
    mirrored warp samples the canvas at another sub-pixel phase, which on
    noise content is small only when the warp magnifies: scales 1.5-2.0,
    as the JAX package's test key draws."""
    s = 64
    rng = np.random.default_rng(5)
    tiles = rng.integers(0, 255, (2, 5, s, s, 3), dtype=np.uint8)
    hw = np.full((2, 5, 2), s, np.float32)
    labels = np.zeros((2, 5, 4, 5), np.float32)
    labels[..., 0, :] = [4, 4, 40, 40, 1]
    draws = td.sample_augment_draws(2, torch.Generator().manual_seed(7),
                                    (s, s), scales=(1.5, 2.0))

    def run(mosaic, flip):
        d = dict(draws, do_flip=torch.full((2,), flip),
                 do_mosaic=torch.full((2,), mosaic))
        return td.augment_with_draws(
            _t(tiles), _t(hw), _t(labels), d, out_size=(s, s), max_labels=8,
            hsv_prob=0.0, mosaic_prob=0.5, mixup_prob=0.0)

    (a_f, l_f), (a_n, l_n) = run(False, True), run(False, False)
    assert torch.equal(a_f, a_n.flip(2))
    assert l_f[0, 0, 1] == s - l_n[0, 0, 1] and torch.equal(l_f[0, 0, 2:],
                                                          l_n[0, 0, 2:])
    (b_f, _), (b_n, _) = run(True, True), run(True, False)
    dev = (b_f - b_n.flip(2)).abs()
    assert dev.mean() < 3.0 and dev.median() < 1.0


def test_static_prob_fast_paths_match_generic():
    """mosaic_prob / hsv_prob of 1.0 skip the plain image and the HSV
    select; the result equals the generic path's at 1 - 2^-30."""
    s = 64
    tiles, hw, labels = _batch(6, 3, s)
    args = (_t(tiles), _t(hw), _t(labels))
    p = 1.0 - 2.0 ** -30
    fast = td.device_augment_batch(*args, torch.Generator().manual_seed(7),
                                   out_size=(s, s), max_labels=8,
                                   mosaic_prob=1.0, hsv_prob=1.0)
    gen = td.device_augment_batch(*args, torch.Generator().manual_seed(7),
                                  out_size=(s, s), max_labels=8,
                                  mosaic_prob=p, hsv_prob=p)
    torch.testing.assert_close(fast[0], gen[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(fast[1], gen[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("train_size", [(96, 96), (48, 48), (40, 72)])
def test_multiscale_resize_matches_jax(train_size):
    rng = np.random.default_rng(sum(train_size))
    imgs = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    packed = rng.uniform(0, 64, (2, 7, 5)).astype(np.float32)
    got = _multiscale_resize(_t(imgs), _t(packed), (64, 64), train_size)
    want = j_resize(jnp.asarray(imgs), jnp.asarray(packed), (64, 64),
                    train_size)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    same = _multiscale_resize(_t(imgs), _t(packed), (64, 64), (64, 64))
    assert same[0] is not None and torch.equal(same[0], _t(imgs))


# ------------------------------------------------------ augmented steps

NUM_CLASSES = 8


@pytest.fixture(scope="module")
def small_module():
    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.depth, cfg.width, cfg.num_classes = 0.33, 0.125, NUM_CLASSES
    return YoloxModule.from_config(cfg, rng_seed=0, device="cpu")


def _step_batch(seed, s=64, b=2):
    tiles, hw, labels = _batch(seed, b, s)
    labels[..., 4] %= NUM_CLASSES
    return _t(tiles), _t(hw), _t(labels)


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


@pytest.mark.parametrize("train_size", [None, (96, 96)])
def test_augmented_step_equals_augment_then_step(small_module, train_size):
    s = 64
    batch = _step_batch(11)
    aug = dict(max_labels=16)

    mod_a = copy.deepcopy(small_module)
    state_a = init_train_state(mod_a, use_ema=False)
    imgs, packed = td.device_augment_batch(
        *batch, torch.Generator().manual_seed(3), out_size=(s, s), **aug)
    imgs, packed = _multiscale_resize(imgs, packed, (s, s), train_size)
    state_a, m_a = make_train_step(mod_a, NUM_CLASSES, use_ema=False)(
        state_a, imgs, packed, 0.01)

    mod_b = copy.deepcopy(small_module)
    state_b = init_train_state(mod_b, use_ema=False)
    fused = make_augmented_train_step(mod_b, NUM_CLASSES, use_ema=False,
                                      augment_kwargs=aug)
    state_b, m_b = fused(state_b, *batch, torch.Generator().manual_seed(3),
                         0.01, (s, s), train_size)
    assert float(m_a["num_fg"]) > 0
    for k in m_a:
        torch.testing.assert_close(m_b[k], m_a[k], rtol=1e-6, atol=0)
    _assert_same(_params(mod_a), _params(mod_b))


def test_pipelined_step_matches_serial(small_module):
    """Three iterations with a multiscale bucket switch: the pipelined
    step's losses and final parameters equal the serial step's, and its
    carried batch equals a fresh prime with the last generator."""
    s = 64
    batch = _step_batch(9)
    aug = dict(max_labels=16)
    tsizes = [(s, s), (96, 96), (s, s)]

    def gen(i):
        return torch.Generator().manual_seed(100 + i)

    mod_a = copy.deepcopy(small_module)
    state_a = init_train_state(mod_a)
    serial = make_augmented_train_step(mod_a, NUM_CLASSES, augment_kwargs=aug)
    losses_a = []
    for i in range(3):
        state_a, m = serial(state_a, *batch, gen(i), 0.01, (s, s), tsizes[i])
        losses_a.append(float(m["total_loss"]))

    mod_b = copy.deepcopy(small_module)
    state_b = init_train_state(mod_b)
    prime, pipe = make_pipelined_train_step(mod_b, NUM_CLASSES,
                                            augment_kwargs=aug)
    imgs, packed = prime(*batch, gen(0), (s, s))
    losses_b = []
    for i in range(3):
        state_b, m, imgs, packed = pipe(state_b, imgs, packed, *batch,
                                        gen(i + 1), 0.01, (s, s), tsizes[i])
        losses_b.append(float(m["total_loss"]))

    np.testing.assert_allclose(losses_b, losses_a, rtol=1e-6)
    assert len(set(losses_a)) == 3
    _assert_same(_params(mod_a), _params(mod_b))
    _assert_same({k: v for k, v in state_a.ema.ema.state_dict().items()},
                 {k: v for k, v in state_b.ema.ema.state_dict().items()})
    imgs_p, packed_p = prime(*batch, gen(3), (s, s))
    assert torch.equal(imgs, imgs_p) and torch.equal(packed, packed_p)


def test_augmented_step_bf16_learns(small_module):
    """bf16 compute: the augmentation's image buffers follow the step's
    dtype, losses stay finite, and repeated steps on one batch learn."""
    s = 64
    batch = _step_batch(13)
    mod = copy.deepcopy(small_module)
    state = init_train_state(mod)
    step = make_augmented_train_step(mod, NUM_CLASSES,
                                     compute_dtype=torch.bfloat16,
                                     fused_bwd=True,
                                     augment_kwargs=dict(max_labels=16))
    imgs, _ = make_pipelined_train_step(
        mod, NUM_CLASSES, compute_dtype=torch.bfloat16,
        augment_kwargs=dict(max_labels=16))[0](
            *batch, torch.Generator().manual_seed(0), (s, s))
    assert imgs.dtype == torch.bfloat16
    losses = []
    for _ in range(10):
        state, m = step(state, *batch, torch.Generator().manual_seed(0), 0.01,
                        (s, s))
        losses.append(float(m["total_loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
