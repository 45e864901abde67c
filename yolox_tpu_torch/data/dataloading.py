"""Data loading for evaluation: the dataset root and the eval loader, the
port's counterpart of the JAX package's `yolox_tpu/data/dataloading.py`.

The loader is `torch.utils.data.DataLoader` over a
`SequentialBatchSampler`, with worker processes when `num_workers > 0`,
and yields what the JAX package's loader yields: `(imgs, targets, infos,
ids)` with `imgs` and `targets` stacked numpy arrays and `infos`, `ids`
lists (`collate`). The training loader comes with the host data path
(ROADMAP M7).
"""

from __future__ import annotations

import os

import numpy as np


def get_yolox_datadir() -> str:
    """Dataset root: $YOLOX_DATADIR, else ./datasets (upstream
    `dataloading.py:16-27`)."""
    yolox_datadir = os.getenv("YOLOX_DATADIR", None)
    if yolox_datadir is None:
        yolox_datadir = os.path.join(os.getcwd(), "datasets")
    return yolox_datadir


def collate(items):
    """Stack (img, labels, info, id) tuples into batch arrays."""
    imgs = np.stack([np.asarray(it[0]) for it in items])
    targets = np.stack([np.asarray(it[1]) for it in items])
    infos = [it[2] for it in items]
    ids = [it[3] for it in items]
    return imgs, targets, infos, ids


def eval_loader(dataset, batch_size: int, num_workers: int = 0,
                rank: int = 0, world_size: int = 1):
    """Sequential evaluation batches of `dataset` (rank-strided)."""
    from torch.utils.data import DataLoader

    from yolox_tpu_torch.data.samplers import SequentialBatchSampler

    sampler = SequentialBatchSampler(len(dataset), batch_size=batch_size,
                                     rank=rank, world_size=world_size)
    return DataLoader(dataset, batch_sampler=sampler,
                      num_workers=num_workers, collate_fn=collate)
