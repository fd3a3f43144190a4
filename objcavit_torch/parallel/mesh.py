"""The process grid: the port's counterpart of the JAX package's 2-D mesh.

Port of ``objcavit_tpu/parallel/mesh.py``'s ``make_mesh(n_data, n_model)``.
JAX reshapes the device list to (data, model); here the processes of the
group take those places: rank ``r`` sits at data index ``r // n_model`` and
model index ``r % n_model``. A grid holds two process groups of its rank:

* the data group, the ranks with this rank's model index: they hold other
  rows of the global batch, and every sum over the batch runs over them
  (``parallel/collectives.py``);
* the model group, the ranks with this rank's data index: they hold the
  same rows and split the attention stacks' weights between them
  (``parallel/tp.py``), joining their partial products by all-reduce.

``make_grid`` builds the groups with ``torch.distributed.new_group`` on
every rank in one order (it is a collective call) and makes the grid this
process's own: ``current_grid()`` returns it until the next ``make_grid``
or ``shutdown_distributed``. Without one, ``current_grid()`` is the grid of
the group alone, ``n_data`` its size and ``n_model`` 1, whose data group is
the whole group: what the collectives took before there were grids. At a
world of one, or with no group, it is the 1 x 1 grid and has no group.

``batch_sharding``, ``replicated_sharding`` and ``shard_batch`` have no
counterpart: each rank keeps its own rows on its own card.
"""

from __future__ import annotations

import torch.distributed as dist

from objcavit_torch.parallel.distributed import process_count, process_index

DATA_AXIS = "data"  # JAX's axis names: a grid's two axes
MODEL_AXIS = "model"


class ProcessGrid:
    """This rank's place in an (n_data, n_model) grid and its two groups.

    A group is None where it holds this rank alone; ``dist.group.WORLD``
    where it is the whole group."""

    def __init__(self, n_data: int, n_model: int, data_index: int = 0, model_index: int = 0,
                 data_group=None, model_group=None):
        self.n_data, self.n_model = n_data, n_model
        self.data_index, self.model_index = data_index, model_index
        self.data_group, self.model_group = data_group, model_group

    def __repr__(self) -> str:
        return (f"ProcessGrid(n_data={self.n_data}, n_model={self.n_model}, "
                f"data_index={self.data_index}, model_index={self.model_index})")


_GRID: ProcessGrid | None = None


def make_grid(n_data: int | None = None, n_model: int = 1) -> ProcessGrid:
    """The (n_data, n_model) grid of this process group, made this
    process's grid. ``n_data`` None takes world // n_model. Every rank must
    call it with the same arguments: it creates every data and model group
    in one order. ValueError unless n_data x n_model is the world."""
    global _GRID
    world = process_count()
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"a grid needs n_data and n_model of at least 1, got {n_data}, {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} grid needs {n_data * n_model} processes, "
                         f"the group has {world}")
    rank = process_index()
    d, m = divmod(rank, n_model)
    grid = ProcessGrid(n_data, n_model, d, m)
    if world > 1:
        for i in range(n_data):  # the model groups, one a data index
            ranks = [i * n_model + j for j in range(n_model)]
            group = _group(ranks, world)
            if i == d:
                grid.model_group = group
        for j in range(n_model):  # the data groups, one a model index
            ranks = [i * n_model + j for i in range(n_data)]
            group = _group(ranks, world)
            if j == m:
                grid.data_group = group
    _GRID = grid
    return grid


def _group(ranks: list[int], world: int):
    """The process group of ``ranks``: None for one rank, the default
    group for all of them, else a new group (made on every rank alike)."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def current_grid() -> ProcessGrid:
    """This process's grid: the last ``make_grid``'s, else the group as an
    (n, 1) grid whose data group is the whole group, else 1 x 1."""
    if _GRID is not None:
        return _GRID
    world = process_count()
    if world == 1:
        return ProcessGrid(1, 1)
    return ProcessGrid(world, 1, process_index(), 0, data_group=dist.group.WORLD)


def reset_grid() -> None:
    """Forget this process's grid (``shutdown_distributed`` calls it)."""
    global _GRID
    _GRID = None
