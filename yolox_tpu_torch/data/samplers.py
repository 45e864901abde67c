"""Batch samplers, the port's copy of the JAX package's
`yolox_tpu/data/samplers.py` (the reference's `yolox/data/samplers.py`).

`InfiniteSampler` is a seeded infinite shuffled index stream, strided by
(rank, world_size). `YoloBatchSampler` yields batches of `(mosaic_flag,
idx, sample_seed)` tuples: the per-sample seed makes a sample's
augmentation a function of (seed, the sample's place in the global
stream), whatever the worker or the rank that builds it. `SequentialBatchSampler` gives the evaluation's finite
batches.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Tuple

import numpy as np


class InfiniteSampler:
    """Infinite shuffled index stream, rank-strided (`samplers.py:28-83`)."""

    def __init__(self, size: int, shuffle: bool = True,
                 seed: Optional[int] = 0, rank: int = 0,
                 world_size: int = 1):
        if size <= 0:
            raise ValueError(f"size must be positive, got {size}")
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed or 0)
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(
            self._infinite_indices(), self.rank, None, self.world_size)

    def _infinite_indices(self):
        rng = np.random.default_rng(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size).tolist()
            else:
                yield from range(self._size)

    def __len__(self):
        return self._size // self.world_size


class YoloBatchSampler:
    """Batches of (mosaic, idx, seed) tuples (`samplers.py:12-25`).

    A sample's seed is its place in the global stream: the k-th sample of
    rank r under a rank-strided sampler is place k * world_size + r. So
    the ranks draw different augmentations, and together the seeds one
    process draws for the same images (the JAX package counts the place
    within its process, which is the same for one process)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False,
                 mosaic: bool = True, seed: int = 0):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.mosaic = mosaic
        self.seed = seed

    def __iter__(self) -> Iterator[List[Tuple[bool, int, int]]]:
        batch = []
        place = getattr(self.sampler, "rank", 0)
        stride = getattr(self.sampler, "world_size", 1)
        for idx in self.sampler:
            sample_seed = (self.seed * 1_000_003 + place) & 0x7FFFFFFF
            batch.append((self.mosaic, int(idx), sample_seed))
            place += stride
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class SequentialBatchSampler:
    """Finite sequential batches for evaluation, rank-strided by batch:
    process r takes batches r, r + world, r + 2 * world, ... so all
    processes make the same number of passes (trailing processes may get
    an empty final batch). Each index is a `(False, i, None)` tuple, the
    `Dataset.mosaic_getitem` protocol with mosaic off."""

    def __init__(self, size: int, batch_size: int, rank: int = 0,
                 world_size: int = 1):
        self.size = size
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size

    def __iter__(self):
        all_batches = [
            [(False, i, None) for i in range(start,
                                             min(start + self.batch_size,
                                                 self.size))]
            for start in range(0, self.size, self.batch_size)
        ]
        for b in all_batches[self.rank::self.world_size]:
            yield b

    def __len__(self):
        n_batches = (self.size + self.batch_size - 1) // self.batch_size
        return (n_batches - self.rank + self.world_size - 1) \
            // self.world_size
