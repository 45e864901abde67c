"""Batch samplers, the port's copy of the evaluation sampler of the JAX
package's `yolox_tpu/data/samplers.py`. The training samplers
(`InfiniteSampler`, `YoloBatchSampler`) come with the host data path
(ROADMAP M7).
"""

from __future__ import annotations


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
