"""Environment setup, the port's copy of the JAX package's
`yolox_tpu/utils/setup_env.py` (the reference's `yolox/utils/setup_env.py`):
taming cv2/OpenMP thread pools around the data workers and raising the
file-descriptor limit for many-worker loaders. The JAX package's
`configure_compilation_cache` (XLA's compile cache) has no counterpart:
eager PyTorch compiles nothing, and the port's CUDA kernels are cached in
`yolox_tpu_torch/_build/`.
"""

from __future__ import annotations

import os


def configure_omp(num_threads: int = 1):
    """Pin OMP threads for data workers (`setup_env.py:26-46`)."""
    if "OMP_NUM_THREADS" not in os.environ:
        os.environ["OMP_NUM_THREADS"] = str(num_threads)


def configure_module(ulimit_value: int = 8192):
    """Raise RLIMIT_NOFILE and disable cv2 threading/OpenCL where cv2 is
    installed (`setup_env.py:49-75`)."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (min(ulimit_value, hard), hard))
    except (ImportError, ValueError, OSError):
        pass
    try:
        import cv2
    except ImportError:
        return
    cv2.setNumThreads(0)
    cv2.ocl.setUseOpenCL(False)
