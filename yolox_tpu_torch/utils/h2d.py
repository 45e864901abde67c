"""The host-to-device copy of an image batch (`YoloxModule._image_batch`,
span `yolox.h2d`).

A pageable source reaches the card through the CUDA driver's own small
pinned bounce buffers, on one host thread, at ~7 GB/s (an H100 host).
`to_device` stages a batch larger than one chunk instead. A pinned tensor
from torch's caching host allocator (which hands a block out again only
after the copies recorded on it have completed) is filled in chunks along
the batch by a small thread pool (`numpy.copyto` releases the GIL and
reads strided sources, such as an NCHW batch seen as NHWC) and by the
calling thread, which stages any chunk no worker has taken by the time it
comes to it. Each chunk's asynchronous copy is issued on a copy stream as
the chunk lands, so the DMA of one chunk overlaps the staging of the
next, and the compute stream waits on the copy stream after the last
chunk. Every call copies its own bytes: nothing is kept across calls but
the pool, each device's copy stream and the allocators' blocks.

The routes, counted in `COUNTS` (read by `utils.trace.copy_counts()`):

    staged         a CPU batch of more than one chunk, not pinned (and
                   its bytes)
    pinned_direct  a pinned CPU source: one asynchronous copy
    pageable       the plain `.to(device)` of a CPU source: a batch of one
                   chunk or less, which one thread stages more slowly than
                   the driver copies it (a 640 px frame: 0.28 against 0.15
                   ms, H100 host), and any source while torch.export or
                   torch.compile traces (once a trace)

A source already on the device is not copied, and a CPU destination takes
the plain `.to`; neither is counted.
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the largest chunk a pool worker stages (a batch no larger takes the
# driver's pageable copy); ~13 letterboxed 640 px uint8 frames
CHUNK_BYTES = 16 << 20
MAX_WORKERS = 8

COUNTS = {"staged": 0, "staged_bytes": 0, "pinned_direct": 0, "pageable": 0}
_lock = threading.Lock()
_pool = None
_streams: dict = {}


def _count(route: str, nbytes: int = 0) -> None:
    with _lock:
        COUNTS[route] += 1
        if nbytes:
            COUNTS[route + "_bytes"] += nbytes


def workers() -> int:
    """The staging pool's size: the host's cores, at most `MAX_WORKERS`."""
    return max(1, min(MAX_WORKERS, os.cpu_count() or 1))


def _staging_pool() -> ThreadPoolExecutor:
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(workers(),
                                       thread_name_prefix="yolox-h2d")
        return _pool


def _copy_stream(device: torch.device):
    with _lock:
        key = torch.cuda.current_device() if device.index is None \
            else device.index
        if key not in _streams:
            _streams[key] = torch.cuda.Stream(key)
        return _streams[key]


def chunk_plan(batch: int, item_bytes: int, chunk_bytes: int = CHUNK_BYTES,
               n_workers: int | None = None) -> list:
    """[(k0, k1)] slices of the batch axis, in order, that cover
    [0, batch): one when the batch fits in `chunk_bytes`, else at least
    one a pool worker (where the batch has the items), none over
    `chunk_bytes` unless one item is, each of at least one item."""
    if batch * item_bytes <= chunk_bytes:
        return [(0, batch)]
    n_workers = n_workers or workers()
    rows = max(1, min(chunk_bytes // item_bytes, batch // n_workers))
    return [(k, min(k + rows, batch)) for k in range(0, batch, rows)]


def _filler(src: torch.Tensor, staged: torch.Tensor):
    """fill(k0, k1) copies src[k0:k1] into staged[k0:k1] on the calling
    thread: `numpy.copyto`, or torch's `copy_` for a dtype numpy lacks
    (bfloat16); both release the GIL."""
    try:
        s, d = src.detach().numpy(), staged.numpy()
    except TypeError:
        return lambda k0, k1: staged[k0:k1].copy_(src[k0:k1])
    return lambda k0, k1: np.copyto(d[k0:k1], s[k0:k1])


def _item_bytes(src: torch.Tensor) -> int:
    return src[0].numel() * src.element_size() if len(src) else 0


def stage(src: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy on `device` of the CPU tensor `src` (B, ...), any
    strides, through a staging tensor filled chunk by chunk
    (`chunk_plan`) by the pool, and by the calling thread where it comes to
    a chunk no worker has taken, and copied on as each chunk lands. On CUDA
    the staging tensor is pinned and the chunks go asynchronously on the
    device's copy stream, which the current stream then waits for; on the
    CPU (the tests) the same chunks are copied in turn."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    plan = chunk_plan(len(src), _item_bytes(src))
    staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
    fill = _filler(src, staged)
    pool = _staging_pool()
    landed = [pool.submit(fill, k0, k1) for k0, k1 in plan]
    stream = _copy_stream(device) if cuda else None
    # the destination comes from the copy stream's blocks: a block the
    # current stream freed may still be read by its queued kernels
    with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
        dst = torch.empty(src.shape, dtype=src.dtype, device=device)
        for (k0, k1), done in zip(plan, landed):
            if done.cancel():  # no worker has taken it: stage it here
                fill(k0, k1)
            else:
                done.result()
            dst[k0:k1].copy_(staged[k0:k1], non_blocking=cuda)
    if cuda:
        compute = torch.cuda.current_stream(device)
        compute.wait_stream(stream)
        dst.record_stream(compute)
    _count("staged", staged.nbytes)
    return dst


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """`x` on `device`, by the route its place decides (the module
    docstring): on the device already, as it is; to a CUDA device, one
    asynchronous copy from a pinned source, a batch of more than one chunk
    staged (`stage`), else the plain `.to`."""
    device = torch.device(device)
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    tracing = torch.compiler.is_exporting() or torch.compiler.is_compiling()
    if not tracing and x.is_pinned():
        _count("pinned_direct")
        return x.to(device, non_blocking=True)
    if tracing or len(chunk_plan(len(x), _item_bytes(x))) < 2:
        _count("pageable")
        return x.to(device)
    return stage(x, device)
