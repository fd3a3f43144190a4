"""Multi-process training (objcavit_tpu.parallel): launch, ranks and the collectives."""

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

__all__ = [
    "initialize_distributed",
    "is_main_process",
    "process_count",
    "process_index",
    "process_local_indices",
    "rank_device",
    "resolve_distributed_args",
    "shutdown_distributed",
]
