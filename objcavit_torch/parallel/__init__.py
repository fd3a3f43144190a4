"""Multi-process training and tensor parallelism (objcavit_tpu.parallel):
launch, ranks, the process grid, the collectives and the attention stacks'
split over the grid's model axis."""

from objcavit_torch.parallel.distributed import (
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
    process_local_indices,
    rank_device,
    resolve_distributed_args,
    shutdown_distributed,
)
from objcavit_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ProcessGrid,
    current_grid,
    make_grid,
)
from objcavit_torch.parallel.tp import (
    count_tp_sharded,
    tp_gather_state_dict,
    tp_shard_model,
    tp_spec_for,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "ProcessGrid",
    "current_grid",
    "make_grid",
    "tp_shard_model",
    "tp_spec_for",
    "count_tp_sharded",
    "tp_gather_state_dict",
    "initialize_distributed",
    "is_main_process",
    "process_count",
    "process_index",
    "process_local_indices",
    "rank_device",
    "resolve_distributed_args",
    "shutdown_distributed",
]
