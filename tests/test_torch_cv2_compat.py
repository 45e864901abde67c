"""The port's cv2-free image operations (`yolox_tpu_torch/data/cv2_compat.py`)
against cv2, on seeded uint8 images.

Bounds: every numpy version is bit-equal to cv2 on these inputs
(resize, warp, HSV both ways exhaustively over all 2^24 triples, the
rotation matrix). The warp's cv2 4.x route cannot meet a cv2 4.x here;
it is checked on properties of its arithmetic. `hsv_to_bgr` rounds where cv2's scalar loop does, in
the last `width % 32` pixels of each row (its vector loop takes 32 pixels
a pass on this host); a cv2 built for another vector width (16 or 64)
would draw that line elsewhere, so the odd-width test allows one level
in the last `width % 64` pixels of a row and nowhere else.
"""

import sys

import cv2
import numpy as np
import pytest

from yolox_tpu.data.data_augment import get_affine_matrix
from yolox_tpu.ops.preproc import preproc as jax_preproc
from yolox_tpu_torch.data import cv2_compat
from yolox_tpu_torch.ops.preproc import preproc
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

RESIZES = [
    ((720, 1280), (640, 360)),    # a video frame letterboxed to 640 (2x)
    ((375, 500), (640, 480)),     # VOC-sized, upscaled
    ((97, 131), (262, 194)),      # upscale
    ((300, 250), (101, 77)),      # downscale, not by 2
    ((1000, 1500), (640, 426)),   # downscale of a large image
    ((64, 64), (128, 128)),       # exact 2x upscale
    ((480, 640), (640, 480)),     # one axis up, one down
]


def _image(seed, hw):
    return np.random.default_rng(seed).integers(0, 256, tuple(hw) + (3,),
                                                dtype=np.uint8)


@pytest.mark.parametrize("src_hw,size_wh", RESIZES)
def test_resize_linear_bit_equal_to_cv2(src_hw, size_wh):
    img = _image(1, src_hw)
    want = cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR)
    got = cv2_compat.resize_linear_numpy(img, size_wh)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # a single-channel image takes the same arithmetic
    np.testing.assert_array_equal(
        cv2_compat.resize_linear_numpy(img[..., 0], size_wh), want[..., 0])


@pytest.mark.parametrize("canvas,out", [(1280, 640), (128, 64), (640, 640)])
def test_warp_affine_bit_equal_to_cv2(canvas, out):
    """Mosaic's affine (rotation, scale 0.1-2, shear, translation from the
    JAX package's `get_affine_matrix`), border 114, 8 draws."""
    rng = np.random.default_rng(canvas + out)
    for _ in range(8):
        img = rng.integers(0, 256, (canvas, canvas, 3), dtype=np.uint8)
        m, _ = get_affine_matrix(rng, (out, out), degrees=10.0,
                                 translate=0.1, scales=(0.1, 2), shear=2.0)
        want = cv2.warpAffine(img, m, dsize=(out, out),
                              borderValue=(114, 114, 114))
        np.testing.assert_array_equal(
            cv2_compat.warp_affine_numpy(img, m, (out, out)), want)


def test_warp_affine_cv2_4_route():
    """cv2 4.x's fixed-point route (`cv2_major=4`), which this host's cv2
    does not run: the identity and an integer shift copy the image (the
    border where nothing maps), a half-pixel shift averages neighbours
    rounding half up, as cv2 4.x's 15-bit weights do."""
    img = _image(4, (48, 64))
    warp = cv2_compat.warp_affine_numpy
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    np.testing.assert_array_equal(warp(img, eye, (64, 48), cv2_major=4), img)
    shifted = warp(img, eye + [[0, 0, 5], [0, 0, -3]], (64, 48), cv2_major=4)
    np.testing.assert_array_equal(shifted[:45, 5:], img[3:, :59])
    assert (shifted[45:] == 114).all() and (shifted[:, :5] == 114).all()
    half = warp(img, eye + [[0, 0, -0.5], [0, 0, 0]], (63, 48), cv2_major=4)
    a = img.astype(np.int64)
    np.testing.assert_array_equal(half, (a[:, :-1] + a[:, 1:] + 1) >> 1)


def _all_colours(chunk):
    """The 2^24 uint8 triples as a (1024, 4096, 3) image, chunk 0-3."""
    flat = np.arange(chunk << 22, (chunk + 1) << 22, dtype=np.int64)
    return np.stack([flat >> 16, (flat >> 8) & 255, flat & 255],
                    -1).astype(np.uint8).reshape(1024, 4096, 3)


@pytest.mark.parametrize("chunk", range(4))
def test_hsv_both_ways_bit_equal_on_all_colours(chunk):
    img = _all_colours(chunk)
    np.testing.assert_array_equal(cv2_compat.bgr_to_hsv_numpy(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    np.testing.assert_array_equal(cv2_compat.hsv_to_bgr_numpy(img),
                                  cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("shape", [(7, 13), (97, 131), (3, 1001)])
def test_hsv_to_bgr_tail_within_one_level(shape):
    """Odd widths: cv2's scalar loop over each row's last pixels rounds,
    its vector loop truncates; bit-equal outside the last width % 64
    pixels of a row, within one level inside them."""
    rng = np.random.default_rng(sum(shape))
    for _ in range(10):
        hsv = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        hsv[..., 0] = rng.integers(0, 180, shape)
        want = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR).astype(int)
        got = cv2_compat.hsv_to_bgr_numpy(hsv).astype(int)
        diff = np.abs(got - want).max(-1)
        assert diff.max() <= 1
        tail = shape[1] % 64
        assert not diff[:, :shape[1] - tail].any(), np.argwhere(diff)[:5]


def test_rotation_matrix_bit_equal_to_cv2():
    rng = np.random.default_rng(5)
    for _ in range(2000):
        angle, scale = rng.uniform(-10, 10), rng.uniform(0.1, 2.0)
        np.testing.assert_array_equal(
            cv2_compat.rotation_matrix_2d(angle, scale),
            cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale))


def test_route_follows_cv2(monkeypatch):
    """cv2 when it imports; the numpy versions, with equal results, when it
    does not (the card's host)."""
    img = _image(2, (720, 1280))
    m, _ = get_affine_matrix(np.random.default_rng(0), (640, 640), 10.0,
                             0.1, (0.1, 2.0), 2.0)
    want = (cv2.resize(img, (640, 360)),
            cv2.warpAffine(img, m, (640, 640), borderValue=(114,) * 3),
            cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    assert cv2_compat.route() == "cv2"
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert cv2_compat.route() == "numpy"
    got = (cv2_compat.resize_linear(img, (640, 360)),
           cv2_compat.warp_affine(img, m, (640, 640)),
           cv2_compat.bgr_to_hsv(img))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_route_is_decided_at_import(monkeypatch):
    """A host whose cv2 did not import takes the numpy route without
    trying `import cv2` again on each call."""
    import builtins

    img = _image(3, (375, 500))
    want = cv2.resize(img, (640, 480), interpolation=cv2.INTER_LINEAR)
    monkeypatch.setattr(cv2_compat, "_CV2", None)
    monkeypatch.delitem(sys.modules, "cv2")
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise AssertionError("cv2_compat tried to import cv2 again")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert cv2_compat.route() == "numpy"
    np.testing.assert_array_equal(cv2_compat.resize_linear(img, (640, 480)),
                                  want)


@pytest.mark.parametrize("shape", [(720, 1280), (375, 500)])
def test_letterbox_without_cv2_equals_jax(shape, monkeypatch):
    """The serving letterbox of frames whose ratio is not 1 runs without
    cv2 (and without Pillow) and equals the JAX package's (cv2)."""
    img = _image(3, shape)
    want, r_want = jax_preproc(img, (640, 640))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got, r = preproc(img, (640, 640))
    assert r == r_want
    np.testing.assert_array_equal(got, want)
