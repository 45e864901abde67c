"""The host-to-device copy's staging (`utils/h2d.py`) on the CPU: the
chunk plan, the staged copy bit-equal to its source whatever the layout,
dtype and batch, the counters under concurrent callers, and a CPU module's
serve taking no staged route. `stage(src, "cpu")` runs the CUDA route's
chunks and pool with an ordinary CPU destination.

Small frames and a chunk of 2 float32 frames, 8 uint8 ones
(`small_chunks`), so that batches of 3 (float32), 17 and 257 cross chunk
edges.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from yolox_tpu_torch import YoloxConfig
from yolox_tpu_torch.models.yolox import YoloxModule, _nhwc
from yolox_tpu_torch.utils import h2d, trace
import tests._torch_threads  # noqa: F401,E402  (one CPU share a worker)

H, W = 12, 8


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(h2d, "CHUNK_BYTES", 2 * H * W * 3 * 4)
    return h2d.CHUNK_BYTES


@pytest.mark.parametrize("batch,item,chunk,n_workers", [
    (1, 100, 1000, 8), (10, 100, 1000, 8), (11, 100, 1000, 8),
    (17, 100, 1000, 8), (257, 100, 1000, 8), (257, 100, 1000, 1),
    (3, 100, 150, 8), (5, 2000, 1000, 4), (256, 640 * 640 * 3, 16 << 20, 8),
    (32, 640 * 640 * 3, 16 << 20, 8), (0, 100, 1000, 8)])
def test_chunk_plan_covers_the_batch(batch, item, chunk, n_workers):
    plan = h2d.chunk_plan(batch, item, chunk, n_workers)
    assert plan[0][0] == 0 and plan[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    if batch * item <= chunk:
        assert plan == [(0, batch)]
        return
    assert all(k1 > k0 for k0, k1 in plan)
    if item <= chunk:
        assert all((k1 - k0) * item <= chunk for k0, k1 in plan)
        assert len(plan) >= min(batch, n_workers)
    else:
        assert all(k1 - k0 == 1 for k0, k1 in plan)


def _source(layout, dtype, b, seed=0):
    """(what the caller passes, the NHWC array it stands for)."""
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        full = rng.integers(0, 256, (b + 2, H + 6, W, 3), dtype=np.uint8)
    else:
        full = rng.uniform(0, 255, (b + 2, H + 6, W, 3)).astype(dtype)
    if layout == "nhwc":
        x = np.ascontiguousarray(full[:b, :H])
        return x, x
    if layout == "nchw":
        x = np.ascontiguousarray(full[:b, :H].transpose(0, 3, 1, 2))
        return x, x.transpose(0, 2, 3, 1)
    # a meshed rank's slab: images [1, 1 + b), rows [2, 2 + H)
    return torch.from_numpy(full)[1:1 + b, 2:2 + H], full[1:1 + b, 2:2 + H]


@pytest.mark.parametrize("b", [1, 3, 17, 257])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw", "rows"])
def test_stage_is_bit_equal_to_its_source(small_chunks, layout, dtype, b):
    x, want = _source(layout, dtype, b, seed=b)
    src = _nhwc(x)
    before = trace.copy_counts()
    got = h2d.stage(src, "cpu")
    assert got.is_contiguous() and got.dtype == src.dtype
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    after = trace.copy_counts()
    assert after["staged"] == before["staged"] + 1
    assert after["staged_bytes"] == before["staged_bytes"] + want.nbytes


def test_stage_copies_a_dtype_numpy_lacks(small_chunks):
    src = torch.randn(17, 3, H, W).to(torch.bfloat16).permute(0, 2, 3, 1)
    got = h2d.stage(src, "cpu")
    assert got.is_contiguous() and torch.equal(got, src)


def test_concurrent_callers_count_every_copy(small_chunks):
    """More callers than cores, a short switch interval: every staged copy
    is counted and equals its source."""
    calls, threads = 6, 2 * (h2d.workers() + 1)
    sources = [_nhwc(_source("nchw", "uint8", 17, seed=s)[0])
               for s in range(threads)]
    before = trace.copy_counts()
    errors = []

    def caller(src):
        try:
            for _ in range(calls):
                if not torch.equal(h2d.stage(src, "cpu"), src):
                    errors.append("unequal")
        except Exception as e:  # reported in the main thread
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=caller, args=(s,)) for s in sources]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert errors == []
    after = trace.copy_counts()
    assert after["staged"] - before["staged"] == calls * threads
    assert after["staged_bytes"] - before["staged_bytes"] == \
        calls * sum(s.numel() for s in sources)


def test_cpu_destination_takes_the_plain_copy():
    x = _nhwc(_source("nchw", "uint8", 3)[0])
    before = trace.copy_counts()
    assert h2d.to_device(x, "cpu") is x
    assert trace.copy_counts() == before


def test_cpu_module_serve_takes_no_staged_route():
    cfg = YoloxConfig.get_named_config("yolox_s")
    cfg.width, cfg.num_classes, cfg.test_size = 0.125, 3, (64, 64)
    module = YoloxModule.from_config(cfg, rng_seed=5, device="cpu")
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8)
    before = trace.copy_counts()
    dets, valid = module.serve(x, conf_thre=0.0)
    assert dets.device.type == "cpu" and valid.shape[0] == 2
    assert trace.copy_counts() == before
