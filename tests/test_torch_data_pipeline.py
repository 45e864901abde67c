"""The port's host data path against the JAX package's, on the CPU.

On the synthetic COCO set (`conftest.coco_dir`) with one seed: the batches
of the port's `config.get_data_loader` (Mosaic, affine, MixUp, HSV, flip,
letterbox) equal the JAX package's bit for bit with cv2; with cv2 hidden
the port runs `data/cv2_compat.py`'s numpy versions and the decoder falls
back to Pillow: labels equal, images within one level on at most 0.1% of
the values (the bound of `tests/test_torch_cv2_compat.py` and Pillow's
decoding; measured here: equal). Also: the sampler streams, `ConcatDataset`
routing, `close_mosaic`, independence from the worker count, `TileDataset`
against the JAX package's, the prefetcher on the CPU, and the decoder
error of a host without cv2 and Pillow.
"""

import itertools
import sys

import numpy as np
import pytest
import torch

from yolox_tpu import YoloxConfig as JConfig
from yolox_tpu.data import InfiniteSampler as JInfiniteSampler
from yolox_tpu.data import YoloBatchSampler as JYoloBatchSampler
from yolox_tpu_torch import YoloxConfig
from yolox_tpu_torch.data import (
    ConcatDataset,
    Dataset,
    DevicePrefetcher,
    InfiniteSampler,
    MixConcatDataset,
    TileDataset,
    YoloBatchSampler,
)
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

BATCHES = 3


def _config(cls, coco_dir, **kw):
    cfg = cls.get_named_config("yolox_s")
    cfg.num_classes = 3
    cfg.input_size = cfg.test_size = (64, 64)
    cfg.data_dir = coco_dir
    cfg.data_num_workers = 0
    cfg.seed = 7
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _take(loader, n=BATCHES):
    return list(itertools.islice(iter(loader), n))


def _jax_batches(coco_dir, no_aug=False, **kw):
    loader = _config(JConfig, coco_dir, **kw).get_data_loader(
        4, no_aug=no_aug)
    try:
        return _take(loader)
    finally:
        loader.close()


def _port_loader(coco_dir, no_aug=False, **kw):
    return _config(YoloxConfig, coco_dir, **kw).get_data_loader(
        4, no_aug=no_aug)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gi, gt, ginfo, gid), (wi, wt, winfo, wid) in zip(got, want):
        assert isinstance(gi, torch.Tensor) and isinstance(gt, torch.Tensor)
        gi, gt = gi.numpy(), gt.numpy()
        wi, wt = np.asarray(wi), np.asarray(wt)
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
        assert [tuple(i) for i in ginfo] == [tuple(i) for i in winfo]
        assert [int(np.asarray(i).ravel()[0]) for i in gid] == \
            [int(np.asarray(i).ravel()[0]) for i in wid]


@pytest.mark.parametrize("no_aug", [False, True])
def test_loader_batches_equal_jax_with_cv2(coco_dir, no_aug):
    want = _jax_batches(coco_dir, no_aug=no_aug)
    loader = _port_loader(coco_dir, no_aug=no_aug)
    got = _take(loader)
    loader.close()
    _assert_batches_equal(got, want)
    imgs, targets = got[0][0].numpy(), got[0][1].numpy()
    assert imgs.shape == (4, 64, 64, 3) and imgs.dtype == np.float32
    assert targets.shape == (4, 120, 5)
    assert (targets.sum(-1) > 0).any()


def test_loader_without_cv2_within_bound(coco_dir, monkeypatch):
    want = _jax_batches(coco_dir)
    monkeypatch.setitem(sys.modules, "cv2", None)
    from yolox_tpu_torch.data import cv2_compat

    assert cv2_compat.route() == "numpy"
    loader = _port_loader(coco_dir)
    got = _take(loader)
    loader.close()
    for (gi, gt, _, _), (wi, wt, _, _) in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), wt)
        diff = np.abs(gi.numpy() - wi)
        assert diff.max() <= 1.0
        assert (diff > 0).mean() <= 1e-3


def test_loader_independent_of_worker_count(coco_dir):
    a = _take(_port_loader(coco_dir, data_num_workers=0))
    loader = _port_loader(coco_dir, data_num_workers=2)
    b = _take(loader)
    loader.close()
    _assert_batches_equal(b, a)


def test_close_mosaic_equals_jax(coco_dir):
    """close_mosaic: the loader's next iteration letterboxes, as JAX's."""
    jloader = _config(JConfig, coco_dir).get_data_loader(4)
    jloader.close_mosaic()
    want = _take(jloader)
    jloader.close()
    loader = _port_loader(coco_dir, data_num_workers=2)
    _take(loader, 1)
    loader.close_mosaic()
    assert loader.batch_sampler.mosaic is False
    got = _take(loader)
    loader.close()
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("rank", [0, 1])
def test_sampler_streams_equal_jax(seed, rank):
    want = list(itertools.islice(iter(JInfiniteSampler(
        23, seed=seed, rank=rank, world_size=2)), 40))
    got = list(itertools.islice(iter(InfiniteSampler(
        23, seed=seed, rank=rank, world_size=2)), 40))
    assert got == want
    jb = JYoloBatchSampler(JInfiniteSampler(23, seed=seed, rank=rank,
                                            world_size=2), 4, seed=seed)
    tb = YoloBatchSampler(InfiniteSampler(23, seed=seed, rank=rank,
                                          world_size=2), 4, seed=seed)
    got = sum(itertools.islice(iter(tb), 5), [])
    want = sum(itertools.islice(iter(jb), 5), [])
    assert [t[:2] for t in got] == [t[:2] for t in want]
    assert len(tb) == len(jb)
    # a sample's seed is its place in the global stream (JAX counts the
    # place within the process): the one-process stream's seeds at this
    # rank's places
    one = sum(itertools.islice(iter(JYoloBatchSampler(
        JInfiniteSampler(23, seed=seed), 4, seed=seed)), 10), [])
    assert got == one[rank::2]


def test_concat_dataset_routing():
    class Fake(Dataset):
        def __init__(self, tag, n):
            super().__init__((32, 32))
            self.tag, self.n = tag, n

        def __len__(self):
            return self.n

        def __getitem__(self, idx):
            return (self.tag, idx)

        def pull_item(self, idx):
            return (self.tag, idx)

    ds = ConcatDataset([Fake("a", 3), Fake("b", 2)])
    assert len(ds) == 5 and ds.input_dim == (32, 32)
    assert ds[0] == ("a", 0) and ds[2] == ("a", 2)
    assert ds[3] == ("b", 0) and ds[4] == ("b", 1)
    assert ds[-1] == ("b", 1)
    assert ds.pull_item(4) == ("b", 1)
    with pytest.raises(ValueError):
        ds[-6]
    mix = MixConcatDataset([Fake("a", 3), Fake("b", 2)])
    assert mix[(True, 4, 0)] == ("b", (True, 1, 0))
    assert mix[1] == ("a", 1)


def test_tile_dataset_equals_jax(coco_dir):
    """The device augmentation's host side: raw tiles, 3 mosaic partners
    and a MixUp partner from the sample's seed, as JAX's."""
    from yolox_tpu.data.device_augment import TileDataset as JTileDataset

    jcfg = _config(JConfig, coco_dir, device_augment=True)
    tcfg = _config(YoloxConfig, coco_dir, device_augment=True)
    jds = JTileDataset(jcfg.get_dataset(), tile_size=64)
    tds = TileDataset(tcfg.get_dataset(), tile_size=64)
    for index in [(True, 0, 5), (True, 7, 123), (True, 11, 99)]:
        for g, w in zip(tds[index][:3], jds[index][:3]):
            np.testing.assert_array_equal(g, w)
    # the device_augment loader serves them batched
    loader = tcfg.get_data_loader(4)
    tiles, labels, hw, ids = _take(loader, 1)[0]
    loader.close()
    assert tiles.shape == (4, 5, 64, 64, 3) and tiles.dtype == torch.uint8
    assert labels.shape == (4, 5, 60, 5) and len(hw) == 4


def test_device_prefetcher_on_cpu(coco_dir):
    loader = _port_loader(coco_dir)
    want = _take(loader, 2)
    pre = DevicePrefetcher(loader, "cpu")
    for wi, wt, winfo, _ in want:
        imgs, targets, infos, _ = pre.next()
        assert isinstance(imgs, torch.Tensor) and imgs.device.type == "cpu"
        np.testing.assert_array_equal(imgs.numpy(), wi.numpy())
        np.testing.assert_array_equal(targets.numpy(), wt.numpy())
        assert infos == winfo
    loader.close()


def test_read_bgr_names_the_missing_decoder(coco_dir, monkeypatch):
    from yolox_tpu_torch.data.datasets.coco import read_bgr

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="no image decoder"):
        read_bgr(f"{coco_dir}/train2017/000000000000.jpg")
