"""Meters, the port's copy of the JAX package's `yolox_tpu/utils/metric.py`
(a re-design of the reference's `yolox/utils/metric.py`).

A windowed `AverageMeter` and the `MeterBuffer` the trainer logs from, a
wall-clock `Timer`, and host / device memory gauges; the device gauge
reads `torch.cuda.max_memory_allocated` on the module's device.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict, deque

__all__ = [
    "AverageMeter",
    "MeterBuffer",
    "Timer",
    "get_total_and_free_memory_mb",
    "mem_usage",
    "device_mem_usage",
]


class AverageMeter:
    """Track a series of values; report windowed median/avg + global avg."""

    def __init__(self, window_size=50):
        self._window = deque(maxlen=window_size)
        self._sum_all = 0.0
        self._n_all = 0

    def update(self, value):
        value = float(value)
        self._window.append(value)
        self._sum_all += value
        self._n_all += 1

    def reset(self):
        self._window.clear()
        self._sum_all = 0.0
        self._n_all = 0

    def clear(self):
        self._window.clear()

    @property
    def latest(self):
        return self._window[-1] if self._window else None

    @property
    def avg(self):
        if not self._window:
            return 0.0
        return sum(self._window) / len(self._window)

    @property
    def median(self):
        if not self._window:
            return 0.0
        vals = sorted(self._window)
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])

    @property
    def global_avg(self):
        return self._sum_all / max(self._n_all, 1e-5)

    @property
    def total(self):
        return self._sum_all


class MeterBuffer(defaultdict):
    """Name -> AverageMeter map with bulk update/reset helpers."""

    def __init__(self, window_size=20):
        super().__init__(
            functools.partial(AverageMeter, window_size=window_size))

    def update(self, values=None, **kwargs):
        merged = dict(values or {})
        merged.update(kwargs)
        for name, value in merged.items():
            if hasattr(value, "item"):   # a 0-d tensor or array
                value = value.item()
            self[name].update(value)

    def get_filtered_meter(self, filter_key="time"):
        return {name: meter for name, meter in self.items()
                if filter_key in name}

    def reset(self):
        for meter in self.values():
            meter.reset()

    def clear_meters(self):
        for meter in self.values():
            meter.clear()


def get_total_and_free_memory_mb():
    import psutil

    vm = psutil.virtual_memory()
    return vm.total / 1024 ** 2, vm.available / 1024 ** 2


def mem_usage():
    """Host RSS in MB."""
    import psutil

    return psutil.Process().memory_info().rss / 1024 ** 2


def device_mem_usage(device=None):
    """Peak allocated bytes on `device` (a CUDA device; default the
    current one) in MB: `torch.cuda.max_memory_allocated`. 0 on the CPU."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return 0.0
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1024 ** 2


class Timer:
    """Wall-clock timer; a caller timing device work synchronises first."""

    def __init__(self):
        self.start = time.perf_counter()

    def since_start(self):
        return time.perf_counter() - self.start
