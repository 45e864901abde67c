"""A run of each cell, on the CPU at a small size with the program in
float32, drives the whole harness past its look for a card: sound, it is
correct; with the timed path broken underneath, `correct` comes out false,
once for each fault the cell can have (no cell spans chips, so none leaves
out an exchange between them)."""

import json
import time

import pytest
import torch

from perfbench import cells
from perfbench_small import HERE, small_cell

SEED = 2 ** 31 + 4242
CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def run(name, seconds=0.5):
    torch.manual_seed(0)
    r = cells.run(small_cell(name), SEED, seconds, False, "cpu",
                  time.perf_counter())
    return r


@pytest.fixture
def module_cls():
    from yolox_tpu_torch import YoloxModule

    return YoloxModule


def _patch_serve(monkeypatch, module_cls, fault):
    serve = module_cls.serve

    def broken(self, x, *a, **k):
        dets, valid = serve(self, x, *a, **k)
        return fault(dets.clone(), valid.clone())

    monkeypatch.setattr(module_cls, "serve", broken)


def half_batch(dets, valid):
    valid[valid.shape[0] // 2:] = False
    return dets, valid


def altered(dets, valid):
    # the first detection's box, where it is made: x1 moved left by its
    # larger side
    side = (dets[:, 0, 2:4] - dets[:, 0, 0:2]).amax(-1)
    dets[:, 0, 0] -= side
    return dets, valid


# every cell whose traffic serves through `YoloxModule.serve`
SERVE_CELLS = [name for name in CELLS if json.loads(
    (HERE / "workloads" / f"{name}.json").read_text())["traffic"]["kind"]
    == "offline_batches"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["check"]
    assert r["counts"]["images"] > 0


@pytest.mark.parametrize("name", SERVE_CELLS)
@pytest.mark.parametrize("fault", [half_batch, altered])
def test_broken_serve_is_not_correct(monkeypatch, module_cls, name, fault):
    _patch_serve(monkeypatch, module_cls, fault)
    assert not run(name)["correct"]
