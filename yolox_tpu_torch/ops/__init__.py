"""Tensor functions and the hand-written CUDA kernels of the PyTorch port.

Importing the package registers the serving kernels as operators
(`ops/library.py`), which exported programs call."""

from yolox_tpu_torch.ops import library  # noqa: F401
