"""The control, the reference computed one precision below the
configuration's (float8 e4m3 convs for bfloat16) in the program's place,
comes out not correct: on the CPU at a small size, and on the card at each
cell's own size (`cuda`; `perfbench/readings.py` reads it over more
seeds)."""

import pytest

from perfbench import cells
from perfbench_small import HERE, small_cell

CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name):
    cell = small_cell(name)
    traffic = cells.module("traffic", cell["traffic"]["kind"])
    r = traffic.control(traffic.setup(cell, 2 ** 31 + 7, "cpu"))
    assert not r["correct"], r["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(cuda_device, name):
    cell = cells.load(name)
    traffic = cells.module("traffic", cell["traffic"]["kind"])
    r = traffic.control(traffic.setup(cell, 2 ** 31 + 11, cuda_device))
    assert not r["correct"], r["check"]


def test_fp8_rounds_values_at_the_tensor_scale():
    import torch

    from perfbench.reference import precision

    # amax -> 448: 0.3 is 134.4 there, which rounds to 128 (3 mantissa
    # bits)
    assert precision.fp8(torch.tensor([1.0, 0.3])).tolist() == \
        pytest.approx([1.0, 128 / 448])
    # it rounds no gradient: a cast under autograd would hand each one
    # back in float8 with no scale
    with pytest.raises(ValueError):
        precision.fp8(torch.ones(2, requires_grad=True))
