"""Share the CPU between pytest-xdist workers in the port's tests.

PyTorch starts as many OpenMP threads as the host has cores in every
process, so N xdist workers each running torch ops oversubscribe the CPU
N times over, and OpenMP's spinning threads then slow a test tens of
times against a run on its own. Importing this module gives each
worker's torch ops its share of the cores (all of them outside xdist).
"""

import os

import torch


def cpu_share() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


torch.set_num_threads(cpu_share())
