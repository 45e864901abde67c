"""Data parallelism and the serving meshes over `torch.distributed`
(`parallel/mesh.py`), the serving meshes' halo exchange
(`parallel/halo.py`)."""

from yolox_tpu_torch.parallel.mesh import (
    MeanReducer,
    ServingMesh,
    all_gather_objects,
    any_rank,
    batch_sharding,
    data_parallel_mesh,
    destroy_distributed,
    dryrun_data_parallel,
    image_sharding,
    init_distributed,
    is_main_process,
    process_count,
    process_index,
    process_rank_and_count,
    serving_mesh,
)

__all__ = [
    "MeanReducer",
    "ServingMesh",
    "all_gather_objects",
    "any_rank",
    "batch_sharding",
    "data_parallel_mesh",
    "destroy_distributed",
    "dryrun_data_parallel",
    "image_sharding",
    "init_distributed",
    "is_main_process",
    "process_count",
    "process_index",
    "process_rank_and_count",
    "serving_mesh",
]
