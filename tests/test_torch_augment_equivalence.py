"""Distribution-level A/B of the port: its device augmentation against its
host pipeline, the port of `tests/test_augment_equivalence.py`.

`device_augment=True` replaces the host `MosaicDetection` pipeline with
the on-device engine (`yolox_tpu_torch/data/device_augment.py`). The two
draw from different random streams, so they are held equal in
distribution: per-sample metrics over 384 independent samples of each,
compared by two-sample z statistics, at the JAX test's sizes (128 px, 16
base images) and with its bounds (`chip_smoke.AUGEQ_*`):

- box count, width, height and area, pad fraction and pixel mean:
  |z| < 4, which at N 384 is any shift above ~0.3 of a sample's sigma;
- the multi-pass interpolation's softening of pixel std and gradient
  energy, (host - device) / host, within [-2%, +12%];
- the MixUp gate: on a set where every image has labels, MixUp changes
  every sample (rate 1.0), as the reference mixes whenever the mosaic
  kept any label row;
- the port's device samples against the JAX package's (`device_augment_batch`
  from key 7, as JAX's test): |z| < 4 on all eight metrics. The streams
  draw differently; the law is the same.

Host samples come from the port's `MosaicDetection` + `TrainTransform`,
device samples from `augment_with_draws` on the draws of a
`torch.Generator` seeded 7, in batches of 64 (`chip_smoke.augeq_*`,
which phase 17 runs on the card with the products in bf16). The metrics
and z are JAX's functions' counterparts, checked equal on these samples.
Nothing is marked slow: the file takes ~15 s on the CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)
import tests.test_augment_equivalence as jeq


@pytest.fixture(scope="module")
def base_dataset():
    return cs.AugeqDataset()


@pytest.fixture(scope="module")
def host_metrics(base_dataset):
    return cs.augeq_metrics(*cs.augeq_host_samples(base_dataset))


@pytest.fixture(scope="module")
def device_samples(base_dataset):
    gen = torch.Generator().manual_seed(cs.AUGEQ_SEED)
    return cs.augeq_device_samples(base_dataset, cs.augeq_draws(gen), "cpu")


def test_sizes_and_bounds_are_jax_test_s():
    assert (cs.AUGEQ_S, cs.AUGEQ_IMAGES, cs.AUGEQ_SAMPLES) == \
        (jeq.S, jeq.N_IMGS, jeq.N_SAMPLES) == (128, 16, 384)
    assert cs.AUGEQ_HYPER == jeq.HYPER and cs.AUGEQ_SCALES == jeq.SCALES
    assert (cs.AUGEQ_Z, cs.AUGEQ_SOFTENING) == (4.0, (-0.02, 0.12))
    assert sorted(cs.AUGEQ_SHARED + cs.AUGEQ_SOFT) == sorted(
        ["n_boxes", "box_w", "box_h", "box_area", "pad_frac", "pix_mean",
         "pix_std", "grad_energy"])


def test_device_vs_host_augment_distributions(base_dataset, host_metrics,
                                              device_samples):
    imgs, labs = device_samples
    assert imgs.shape == (cs.AUGEQ_SAMPLES, cs.AUGEQ_S, cs.AUGEQ_S, 3)
    assert labs.shape == (cs.AUGEQ_SAMPLES, 120, 5)
    assert np.isfinite(imgs).all() and np.isfinite(labs).all()
    dm = cs.augeq_metrics(imgs, labs)
    # the metrics and z are JAX's
    jm = jeq._per_image_metrics(imgs, labs)
    for k in jm:
        np.testing.assert_array_equal(dm[k], jm[k], err_msg=k)
        assert cs.augeq_z(host_metrics[k], dm[k]) == \
            jeq._z(host_metrics[k], jm[k])
    cmp = cs.augeq_compare(host_metrics, dm)
    assert not cs.augeq_failures(cmp), (cmp, {
        k: (host_metrics[k].mean(), dm[k].mean()) for k in dm})


def test_device_mixup_gate_rate_matches_host(base_dataset):
    gen = torch.Generator().manual_seed(cs.AUGEQ_SEED)
    assert cs.augeq_mixup_rate(base_dataset, gen, "cpu") == 1.0


def test_device_samples_follow_jax_s_law(base_dataset, device_samples):
    jm = jeq._per_image_metrics(*jeq._device_samples(base_dataset,
                                                     jeq.N_SAMPLES))
    dm = cs.augeq_metrics(*device_samples)
    zs = {k: cs.augeq_z(dm[k], jm[k]) for k in dm}
    assert all(abs(z) < cs.AUGEQ_Z for z in zs.values()), zs


def test_bounds_catch_a_shift(host_metrics, device_samples):
    """The check fails on a shifted engine: pixels 5% darker than the
    port's, or every box dropped but one."""
    imgs, labs = device_samples
    dark = cs.augeq_compare(host_metrics, cs.augeq_metrics(imgs * 0.95,
                                                           labs))
    assert "pix_mean" in [b.split(":")[0] for b in cs.augeq_failures(dark)]
    one = labs.copy()
    one[:, 1:] = 0
    fewer = cs.augeq_compare(host_metrics, cs.augeq_metrics(imgs, one))
    assert "n_boxes" in [b.split(":")[0] for b in cs.augeq_failures(fewer)]


def test_host_samples_equal_jax_s(base_dataset):
    """The host side of the check is JAX's host pipeline, sample for
    sample (the port's MosaicDetection takes JAX's draws in its order)."""
    n = cs.AUGEQ_BATCH
    imgs, labs = cs.augeq_host_samples(base_dataset, n)
    jimgs, jlabs = jeq._host_samples(base_dataset, n)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labs, jlabs)
