"""Dataset base classes, the port's copy of the JAX package's
`yolox_tpu/data/datasets/datasets_wrapper.py` (upstream YOLOX's, without
torch's Dataset base).

`Dataset` carries a mutable `input_dim` (multiscale training) and the
`mosaic_getitem` protocol: the batch sampler passes `(mosaic_flag, idx,
seed)` tuples so mosaic can be toggled mid-training and every sample draw is
deterministically seeded. `ConcatDataset` chains datasets and
`MixConcatDataset` forwards the sampler's tuples to the dataset an index
falls in. `CacheDataset` adds RAM/disk image caching with a thread-pool
warmup.
"""

from __future__ import annotations

import bisect
import copy
import os
import random
from abc import ABCMeta, abstractmethod
from functools import partial, wraps
from multiprocessing.pool import ThreadPool

import numpy as np

from yolox_tpu_torch.utils.logger import logger


class Dataset:
    """Base dataset with on-the-fly `input_dim` resizing."""

    def __init__(self, input_dimension, mosaic=True):
        self.__input_dim = input_dimension[:2]
        self.enable_mosaic = mosaic

    @property
    def input_dim(self):
        if hasattr(self, "_input_dim"):
            return self._input_dim
        return self.__input_dim

    def __len__(self):
        raise NotImplementedError

    @staticmethod
    def mosaic_getitem(getitem_fn):
        """Wrap __getitem__ to accept `(mosaic_flag, idx[, seed])` tuples.

        The optional third element seeds a per-sample numpy Generator
        (`self._rng`), giving worker-count-independent determinism
        (upstream reseeds per worker from uuid4).
        """

        @wraps(getitem_fn)
        def wrapper(self, index):
            if not isinstance(index, int):
                self.enable_mosaic = index[0]
                if len(index) > 2 and index[2] is not None:
                    self._rng = np.random.default_rng(index[2])
                index = index[1]
            return getitem_fn(self, index)

        return wrapper

    @property
    def rng(self) -> np.random.Generator:
        if not hasattr(self, "_rng"):
            self._rng = np.random.default_rng()
        return self._rng


class ConcatDataset(Dataset):
    """Datasets end to end (upstream `datasets_wrapper.py:69-100`)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets should not be empty")
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()
        if hasattr(self.datasets[0], "input_dim"):
            self._input_dim = self.datasets[0].input_dim

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        if idx < 0:
            if -idx > len(self):
                raise ValueError(
                    "absolute value of index should not exceed dataset "
                    "length")
            idx = len(self) + idx
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else (
            idx - self.cumulative_sizes[dataset_idx - 1])
        return dataset_idx, sample_idx

    def __getitem__(self, idx):
        dataset_idx, sample_idx = self._locate(idx)
        return self.datasets[dataset_idx][sample_idx]

    def pull_item(self, idx):
        dataset_idx, sample_idx = self._locate(idx)
        return self.datasets[dataset_idx].pull_item(sample_idx)


class MixConcatDataset(ConcatDataset):
    """`ConcatDataset` that takes the sampler's `(mosaic, idx, seed)`
    tuples, remaps idx into the dataset it falls in and forwards the tuple
    (upstream `datasets_wrapper.py:103-122`)."""

    def __getitem__(self, index):
        if not isinstance(index, int):
            idx = index[1]
        else:
            idx = index
        dataset_idx, sample_idx = self._locate(idx)
        if not isinstance(index, int):
            index = (index[0], sample_idx, *index[2:])
        return self.datasets[dataset_idx][index]


class CacheDataset(Dataset, metaclass=ABCMeta):
    """RAM/disk image cache (upstream `datasets_wrapper.py:125-267`)."""

    def __init__(self, input_dimension, num_imgs=None, data_dir=None,
                 cache_dir_name=None, path_filename=None, cache=False,
                 cache_type="ram"):
        super().__init__(input_dimension)
        self.cache = cache
        self.cache_type = cache_type

        if self.cache and self.cache_type == "disk":
            self.cache_dir = os.path.join(data_dir, cache_dir_name)
            self.path_filename = path_filename
        if self.cache and self.cache_type == "ram":
            self.imgs = None
        if self.cache:
            self.cache_images(num_imgs=num_imgs, data_dir=data_dir,
                              cache_dir_name=cache_dir_name,
                              path_filename=path_filename)

    @abstractmethod
    def read_img(self, index):
        raise NotImplementedError

    def cache_images(self, num_imgs=None, data_dir=None, cache_dir_name=None,
                     path_filename=None):
        assert num_imgs is not None, (
            "num_imgs must be specified as the size of the dataset")
        if self.cache_type == "disk":
            assert (data_dir and cache_dir_name and path_filename) \
                is not None, (
                "data_dir, cache_name and path_filename must be specified "
                "if cache_type is disk")
            self.path_filename = path_filename

        import psutil

        mem = psutil.virtual_memory()
        mem_required = self.cal_cache_occupy(num_imgs)
        gb = 1 << 30

        if self.cache_type == "ram":
            if mem_required > mem.available:
                self.cache = False
            else:
                logger.info(
                    f"{mem_required / gb:.1f}GB RAM required, "
                    f"{mem.available / gb:.1f}/{mem.total / gb:.1f}GB "
                    "RAM available")

        if self.cache and getattr(self, "imgs", True) is None \
                or (self.cache and self.cache_type == "disk"):
            if self.cache_type == "ram":
                self.imgs = [None] * num_imgs
                logger.info("Caching images in RAM to accelerate training")
            else:
                if not os.path.exists(self.cache_dir):
                    os.makedirs(self.cache_dir, exist_ok=True)
                    logger.warning(
                        f"Caching images to DISK ({self.cache_dir}); needs "
                        f"~{mem_required / gb:.1f}GB of disk space")
                else:
                    logger.info(f"Found disk cache at {self.cache_dir}")
                    return

            num_threads = min(8, max(1, (os.cpu_count() or 2) - 1))
            load_imgs = ThreadPool(num_threads).imap(
                partial(self.read_img, use_cache=False), range(num_imgs))
            for i, x in enumerate(load_imgs):
                if self.cache_type == "ram":
                    self.imgs[i] = x
                else:
                    cache_filename = \
                        f"{self.path_filename[i].split('.')[0]}.npy"
                    cache_path = os.path.join(self.cache_dir, cache_filename)
                    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                    np.save(cache_path, x)

    def cal_cache_occupy(self, num_imgs):
        cache_bytes = 0
        num_samples = min(num_imgs, 32)
        for _ in range(num_samples):
            img = self.read_img(
                index=random.randint(0, num_imgs - 1), use_cache=False)
            cache_bytes += img.nbytes
        return cache_bytes * num_imgs / num_samples


def cache_read_img(use_cache=True):
    def decorator(read_img_fn):
        @wraps(read_img_fn)
        def wrapper(self, index, use_cache=use_cache):
            cache = self.cache and use_cache
            if cache:
                if self.cache_type == "ram":
                    return copy.deepcopy(self.imgs[index])
                elif self.cache_type == "disk":
                    return np.load(os.path.join(
                        self.cache_dir,
                        f"{self.path_filename[index].split('.')[0]}.npy"))
                raise ValueError(f"Unknown cache type: {self.cache_type}")
            return read_img_fn(self, index)

        return wrapper

    return decorator
