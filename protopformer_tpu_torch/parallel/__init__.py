from protopformer_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from protopformer_tpu_torch.parallel.multihost import (
    assemble_global_batch,
    barrier,
    initialize_multihost,
    is_main_process,
    local_rank,
    process_count,
    process_index,
    shard_index_for_process,
)

__all__ = [
    "Mesh",
    "assemble_global_batch",
    "barrier",
    "initialize_multihost",
    "is_main_process",
    "local_rank",
    "make_mesh",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "shard_index_for_process",
]
