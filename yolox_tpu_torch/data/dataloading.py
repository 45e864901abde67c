"""Data loading, the port's counterpart of the JAX package's
`yolox_tpu/data/dataloading.py` (the reference's
`yolox/data/dataloading.py` and `data_prefetcher.py`).

`DataLoader` runs batch assembly in `torch.utils.data.DataLoader` worker
processes (each worker builds a whole batch: mosaic, affine, letterbox;
at most two batches a worker in flight) and yields `(imgs, targets,
infos, ids)` as the JAX package's loader does, the first two as CPU
tensors holding its numpy arrays (`collate_tensors`: a worker hands them
over in shared memory; pickled through a pipe, a B 16 float32 640 px
batch took longer to cross than to build). The batch sampler hands every
sample its seed, so a batch does not depend on the worker count.
`eval_loader` gives the evaluation's sequential batches as numpy arrays;
its workers hand them over in shared memory too (pickled, a B 32
float32 640 px batch held the `eval` command to ~14 img/s on an H100's
host).

`DevicePrefetcher` keeps the next batch's host-to-device copy in flight:
a `non_blocking` copy on a side CUDA stream, which the consumer's stream
waits on through an event recorded after the copy. The batch is already
in pinned host memory: a loader made with `pin_memory=True` pins it in
the background thread of `torch.utils.data.DataLoader`, so neither the
copy nor the pinning waits on the main thread. On the CPU it hands the
batch on as tensors.
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


def collate_tensors(items):
    """`collate` with the two arrays as tensors: a worker hands them to
    the main process through shared memory instead of pickling them
    through a pipe."""
    import torch

    imgs, targets, infos, ids = collate(items)
    return torch.from_numpy(imgs), torch.from_numpy(targets), infos, ids


def worker_context(num_workers: int):
    """The multiprocessing context of the loaders' workers: fork, where the
    platform has it, also in a process that was itself spawned (a
    data-parallel rank of `torch.multiprocessing.spawn` or of the CLI's
    `-d`), where Python's default is to spawn each worker anew, and every
    loader start then re-imports the program and torch (~17 s a start on
    an H100's host). None without workers."""
    import multiprocessing as mp

    if num_workers > 0 and "fork" in mp.get_all_start_methods():
        return mp.get_context("fork")
    return None


def _worker_init(_worker_id):
    # cv2 must not spawn threads inside data workers (`setup_env.py:59-75`)
    try:
        import cv2
    except ImportError:
        return
    cv2.setNumThreads(0)


def eval_loader(dataset, batch_size: int, num_workers: int = 0,
                rank: int = 0, world_size: int = 1):
    """Sequential evaluation batches of `dataset` (rank-strided): `collate`'s
    numpy arrays, views of the tensors `collate_tensors` made in a
    worker."""
    from torch.utils.data import DataLoader as TorchDataLoader

    from yolox_tpu_torch.data.samplers import SequentialBatchSampler

    class EvalLoader(TorchDataLoader):
        def __iter__(self):
            for imgs, targets, infos, ids in super().__iter__():
                yield imgs.numpy(), targets.numpy(), infos, ids

    sampler = SequentialBatchSampler(len(dataset), batch_size=batch_size,
                                     rank=rank, world_size=world_size)
    return EvalLoader(dataset, batch_sampler=sampler,
                      num_workers=num_workers, collate_fn=collate_tensors,
                      worker_init_fn=_worker_init if num_workers > 0
                      else None,
                      multiprocessing_context=worker_context(num_workers))


class DataLoader:
    """Training batches (imgs, targets, infos, ids) of `dataset` in the
    order of `batch_sampler`, built in `num_workers` worker processes (0:
    in this process). With `pin_memory` the batch arrays arrive in pinned
    host memory (for a CUDA consumer). Each iteration starts its own
    workers; `close` stops them."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 0,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self._live = []

    def __iter__(self):
        batches = self._batches()
        self._live.append(batches)
        return batches

    def _batches(self):
        from torch.utils.data import DataLoader as TorchDataLoader

        loader = TorchDataLoader(
            self.dataset, batch_sampler=self.batch_sampler,
            num_workers=self.num_workers, collate_fn=collate_tensors,
            pin_memory=self.pin_memory,
            worker_init_fn=_worker_init if self.num_workers > 0 else None,
            multiprocessing_context=worker_context(self.num_workers))
        # the workers stop when this generator is closed or collected
        yield from loader

    def __len__(self):
        return len(self.batch_sampler)

    def close_mosaic(self):
        """Turn off mosaic for the batches of later iterations
        (`dataloading.py:84-88`) and stop the current workers."""
        self.batch_sampler.mosaic = False
        self.close()

    def close(self):
        for batches in self._live:
            batches.close()
        self._live.clear()


class DevicePrefetcher:
    """Double-buffered host->device transfer (the reference's
    `DataPrefetcher`, `data_prefetcher.py:6-49`): while batch k is
    consumed, batch k+1 is already on its way to `device`."""

    def __init__(self, loader, device):
        import torch

        self.loader = iter(loader)
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._next = None
        self._ready = None
        self._preload()

    def _put(self, arr):
        import torch

        t = torch.as_tensor(arr)
        if self._stream is None:
            return t
        return t.to(self.device, non_blocking=True)

    def _preload(self):
        import torch

        try:
            imgs, targets, infos, ids = next(self.loader)
        except StopIteration:
            self._next = None
            return
        if self._stream is None:
            self._next = (self._put(imgs), self._put(targets), infos, ids)
            return
        with torch.cuda.stream(self._stream):
            self._next = (self._put(imgs), self._put(targets), infos, ids)
            self._ready = torch.cuda.Event()
            self._ready.record(self._stream)

    def next(self):
        """The next (imgs, targets, infos, ids) on the device, or None."""
        import torch

        batch = self._next
        if batch is None:
            return None
        if self._stream is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(self._ready)
            for t in batch[:2]:
                t.record_stream(consumer)
        self._preload()
        return batch

    def __iter__(self):
        while True:
            batch = self.next()
            if batch is None:
                return
            yield batch
