"""Multi-process launch: one process per card, joined into one process group.

Port of ``objcavit_tpu/parallel/distributed.py``. The reference scales by
Lightning spawning one process per GPU under DDP (main.py:66,104,129-131);
the port does the same with ``torch.distributed``:

    OBJCAVIT_COORDINATOR=host0:1234 \\
    OBJCAVIT_NUM_PROCESSES=4 OBJCAVIT_PROCESS_ID=<p> python -m objcavit_torch.cli -c cfg

or, on one machine, ``python -m objcavit_torch.parallel.launch -n 4 -- python
-m objcavit_torch.cli -c cfg`` (``parallel/launch.py``), which sets that env
for each process. ``initialize_distributed()`` (``cli.main`` calls it
before it builds anything) reads the env, or explicit arguments, and runs
``torch.distributed.init_process_group`` on ``tcp://<coordinator>``: NCCL
on the card, gloo on the CPU, or the ``backend`` the caller names. With no
env and no arguments it is a strict no-op, so a single-process run is
untouched.

Semantics, the JAX package's (docs/MIGRATION.md "DDP recipe mapping"): the
GLOBAL batch stays ``basic.batch_size`` whatever the process count. Each
process loads rows ``[process_id::process_count]`` of every global batch
(the DistributedSampler interleave, ``data/loader.py``), and the train step
gives the loss and the gradient of the global batch
(``parallel/collectives.py``). A reference N-GPU DDP run has a global batch
of ``batch_size x N``; set ``basic.batch_size = ref_batch_size * N`` to
reproduce it.

No counterpart: ``shard_host_local_batch``, ``batch_sharding``,
``replicated_sharding`` and ``shard_batch`` assemble one global array over
a device mesh. Here each rank keeps its own rows on its own card, and the
collectives of ``parallel/collectives.py`` join them where the global batch
is read. ``make_mesh``'s counterpart is ``parallel/mesh.py::make_grid``, a
(data, model) grid of the group's processes; the model axis splits the
attention stacks (``parallel/tp.py``).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from objcavit_torch.utils.device import card_device

ENV_COORDINATOR = "OBJCAVIT_COORDINATOR"
ENV_NUM_PROCESSES = "OBJCAVIT_NUM_PROCESSES"
ENV_PROCESS_ID = "OBJCAVIT_PROCESS_ID"
ENV_DEVICE = "OBJCAVIT_DEVICE"  # the device cli.main takes when its caller names none


def resolve_distributed_args(env: Any = None) -> dict | None:
    """Env -> ``initialize_distributed`` arguments, or None for one process.

    All three variables must be set together; a partial set is a
    configuration error and raises instead of silently running alone.
    """
    env = os.environ if env is None else env
    raw = {
        "coordinator_address": env.get(ENV_COORDINATOR),
        "num_processes": env.get(ENV_NUM_PROCESSES),
        "process_id": env.get(ENV_PROCESS_ID),
    }
    n_set = sum(v is not None for v in raw.values())
    if n_set == 0:
        return None
    if n_set < 3:
        missing = [k for k, v in raw.items() if v is None]
        raise ValueError(
            f"partial multi-process config: set {ENV_COORDINATOR}, "
            f"{ENV_NUM_PROCESSES} and {ENV_PROCESS_ID} together "
            f"(missing: {missing})"
        )
    args = {
        "coordinator_address": raw["coordinator_address"],
        "num_processes": int(raw["num_processes"]),
        "process_id": int(raw["process_id"]),
    }
    if not 0 <= args["process_id"] < args["num_processes"]:
        raise ValueError(
            f"process_id {args['process_id']} outside "
            f"[0, {args['num_processes']})"
        )
    return args


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           backend: str | None = None, device="cuda") -> bool:
    """Join the process group that explicit arguments or the OBJCAVIT_* env
    describe; -> True, or False on the single-process path (no env, no
    arguments), a strict no-op.

    ``backend`` None takes NCCL for a CUDA ``device`` and gloo for the CPU;
    NCCL on the CPU raises ValueError, a CUDA device without a card raises
    RuntimeError (``card_device``), and a failed NCCL init raises: nothing
    falls back to gloo. A CUDA rank is bound to card ``process_id % count``
    (``rank_device``) before the group forms. One all-reduce checks the group
    before this returns. A group already joined raises RuntimeError.
    """
    if coordinator_address is not None:
        args = {"coordinator_address": coordinator_address,
                "num_processes": int(num_processes), "process_id": int(process_id)}
    else:
        args = resolve_distributed_args()
    if args is None:
        return False
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dev = card_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
    rank, world = args["process_id"], args["num_processes"]
    kwargs = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev  # the communicator forms now, not at a first collective
    dist.init_process_group(backend, init_method=f"tcp://{args['coordinator_address']}",
                            world_size=world, rank=rank, **kwargs)
    check = torch.ones((), device=dev)
    dist.all_reduce(check)
    if int(check) != world:
        raise RuntimeError(f"the {backend} group's check summed to {int(check)}, not {world}")
    return True


def process_index() -> int:
    """This process's rank in the group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the process that owns run-dir writes (checkpoints,
    hparams.yaml, TensorBoard, validation_output.txt): rank 0, or always in
    a single-process run. The reference's Lightning rank-zero semantics."""
    return process_index() == 0


def process_local_indices(idxs: np.ndarray, process_id: int, process_count: int) -> np.ndarray:
    """This process's rows of one GLOBAL batch: the [p::P] interleave
    (torch DistributedSampler semantics, what Lightning DDP uses for the
    reference's loaders). Disjoint and jointly covering across processes."""
    return idxs[process_id::process_count]


def rank_device(device="cuda") -> torch.device:
    """The device this process builds on: in a group, a CUDA device without
    an index is card ``rank % count``; else ``card_device(device)``."""
    dev = card_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


def shutdown_distributed() -> None:
    """Leave the process group, where there is one, and forget the process
    grid made in it (``parallel/mesh.py``)."""
    from objcavit_torch.parallel.mesh import reset_grid

    reset_grid()
    if dist.is_initialized():
        dist.destroy_process_group()
