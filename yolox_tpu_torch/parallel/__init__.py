"""Data parallelism over `torch.distributed` (`parallel/mesh.py`)."""

from yolox_tpu_torch.parallel.mesh import (
    MeanReducer,
    all_gather_objects,
    any_rank,
    destroy_distributed,
    dryrun_data_parallel,
    init_distributed,
    is_main_process,
    process_count,
    process_index,
    process_rank_and_count,
)

__all__ = [
    "MeanReducer",
    "all_gather_objects",
    "any_rank",
    "destroy_distributed",
    "dryrun_data_parallel",
    "init_distributed",
    "is_main_process",
    "process_count",
    "process_index",
    "process_rank_and_count",
]
