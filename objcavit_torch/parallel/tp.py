"""Tensor parallelism of the attention stacks over the grid's model axis.

Port of ``objcavit_tpu/parallel/tp.py``. The JAX package places the
attention stacks' weights Megatron-style on the mesh's "model" axis and
lets GSPMD insert the collectives; the port splits the parameters of each
rank in place and runs the split blocks with the collectives written out
(``models/layers.py``: ``copy_to_model`` on a block's input,
``reduce_from_model`` on its output, ``parallel/collectives.py``). The
split parameters, in the port's torch layout:

  * attention ``in_proj_weight`` (3E, E) and ``in_proj_bias`` (3E): dim 0,
    JAX's column split of ``in_proj_kernel`` (E, 3E);
  * attention ``out_proj.weight`` (E, E): dim 1, JAX's row split of
    ``out_kernel``; its bias is added once, after the reduce;
  * FFN ``linear1.weight`` (F, E) and ``linear1.bias``: dim 0;
  * FFN ``linear2.weight`` (E, F): dim 1; its bias after the reduce;

everything else replicated. Each split attention and each split FFN costs
one all-reduce of its output forward and one of its input's gradient
backward.

One divergence from JAX, on purpose: JAX splits the packed q|k|v columns of
``in_proj_kernel`` contiguously, so a shard holds all of q and part of k,
and GSPMD reshards around the split (``objcavit_tpu/parallel/tp.py:19-24``).
The port splits by heads: model rank m holds heads [m H/n, (m+1) H/n) of q,
of k and of v (rows [m E/n, (m+1) E/n) of each third of ``in_proj``), so
kernel 5 runs unchanged on each rank's heads. The function is the same. So
an attention whose head count n does not divide stays replicated, where JAX
would still split it wherever 3E % n == 0 (at n = 8 with 4 heads, say). A
dim that does not divide stays replicated, as in JAX (``tp.py:82-84``);
``tp_shard_model`` logs what stayed replicated.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from objcavit_torch.parallel.collectives import stack_over
from objcavit_torch.parallel.mesh import ProcessGrid, current_grid

# a split block's parameters, by their names inside the block
ATTENTION_PARAMS = ("in_proj_weight", "in_proj_bias", "out_proj.weight")
FFN_PARAMS = ("linear1.weight", "linear1.bias", "linear2.weight")


def tp_spec_for(name: str, param: torch.Tensor, n_model: int,
                num_heads: int | None = None) -> int | None:
    """The dim of parameter ``name`` (a port state-dict name) that a model
    axis of ``n_model`` ranks splits, or None (replicated). The attention's
    parameters split by heads: ``num_heads``, the attention's head count,
    must divide by ``n_model`` (ValueError without it). A dim that does not
    divide stays replicated."""
    if n_model == 1:
        return None
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if leaf in ("in_proj_weight", "in_proj_bias"):
        dim = 0
    elif (parent, leaf) == ("out_proj", "weight"):
        dim = 1
    elif parent == "linear1" and leaf in ("weight", "bias"):
        return 0 if param.shape[0] % n_model == 0 else None
    elif (parent, leaf) == ("linear2", "weight"):
        return 1 if param.dim() == 2 and param.shape[1] % n_model == 0 else None
    else:
        return None
    if num_heads is None:
        raise ValueError(f"{name}: an attention's split follows its heads; give num_heads")
    return dim if num_heads % n_model == 0 else None


def _blocks(model: torch.nn.Module):
    """(prefix, module, its split parameters' names, head count) of every
    block the model axis may split: each ``MultiHeadAttention`` and each
    ``TransformerEncoderLayer``'s FFN."""
    # here, not at the top: the models import the collectives of this package
    from objcavit_torch.models.layers import MultiHeadAttention, TransformerEncoderLayer

    for prefix, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            yield prefix, m, ATTENTION_PARAMS, m.num_heads
        elif isinstance(m, TransformerEncoderLayer):
            yield prefix, m, FFN_PARAMS, None


def tp_specs(model: torch.nn.Module, n_model: int) -> dict[str, int]:
    """{parameter name: split dim} of the parameters a model axis of
    ``n_model`` ranks splits, in ``named_modules`` order. Called on a split
    model, the specs it was split by."""
    out = {}
    for prefix, m, names, heads in _blocks(model):
        split = getattr(m, "tp_split", None)
        for local in names:
            full = f"{prefix}.{local}" if prefix else local
            if split is not None:
                if local in split:
                    out[full] = split[local]
                continue
            dim = tp_spec_for(full, m.get_parameter(local), n_model, heads)
            if dim is not None:
                out[full] = dim
    return out


def count_tp_sharded(model: torch.nn.Module, n_model: int) -> int:
    """How many parameters a model axis of ``n_model`` ranks splits."""
    return len(tp_specs(model, n_model))


def _packs(local: str) -> int:
    """q, k and v: ``in_proj``'s three blocks split alike."""
    return 3 if local.startswith("in_proj") else 1


def _slice(t: torch.Tensor, dim: int, packs: int, index: int, n: int) -> torch.Tensor:
    """Block ``index`` of ``n`` along ``dim`` of each of ``packs`` equal parts."""
    parts = t.unflatten(dim, (packs, t.shape[dim] // packs))
    width = parts.shape[dim + 1] // n
    return parts.narrow(dim + 1, index * width, width).flatten(dim, dim + 1)


def _join(slices: list[torch.Tensor], dim: int, packs: int) -> torch.Tensor:
    """``_slice``'s inverse: the model ranks' slices, in order, as one tensor."""
    parts = [s.unflatten(dim, (packs, s.shape[dim] // packs)) for s in slices]
    return torch.cat(parts, dim + 1).flatten(dim, dim + 1)


def tp_shard_model(model: torch.nn.Module, grid: ProcessGrid | None = None) -> dict[str, int]:
    """Split ``model``'s attention stacks over ``grid``'s model axis (the
    process's grid if None): each split parameter's data becomes this
    rank's slice, in place (an optimizer made before keeps its parameters),
    its ``tp_dim`` the split dim (``GradientReducer`` reads it), and each
    block whose parameters split runs its model group's collectives. A block that does not split stays replicated, and the log
    names it. -> the specs ({name: dim}). Every rank of the grid must call
    it on the same model."""
    grid = current_grid() if grid is None else grid
    specs = tp_specs(model, grid.n_model)
    if grid.n_model == 1:
        return specs
    replicated, n_split = [], 0
    for prefix, m, names, _ in _blocks(model):
        if getattr(m, "tp", None) is not None:
            raise RuntimeError(f"{prefix or type(model).__name__} is split already")
        full = [f"{prefix}.{local}" if prefix else local for local in names]
        split = [n in specs for n in full]
        if not any(split):
            replicated.append(prefix)
            continue
        if not all(split):
            raise ValueError(f"{prefix}: only some of {list(names)} split over "
                             f"{grid.n_model} ranks")
        with torch.no_grad():
            for local, name in zip(names, full):
                p = m.get_parameter(local)
                p.data = _slice(p.data, specs[name], _packs(local), grid.model_index,
                                grid.n_model).contiguous().clone()
                p.tp_dim = specs[name]
        m.tp = grid
        m.tp_split = {local: specs[name] for local, name in zip(names, full)}
        n_split += 1
    if replicated:
        logging.info("tp: %d of %d blocks stay replicated over %d model ranks (their heads or "
                     "FFN width do not divide): %s", len(replicated), len(replicated) + n_split,
                     grid.n_model, ", ".join(replicated))
    return specs


def split_parameters(model: torch.nn.Module) -> list[torch.nn.Parameter]:
    """The parameters ``tp_shard_model`` split (their ``tp_dim`` set)."""
    return [p for p in model.parameters() if getattr(p, "tp_dim", None) is not None]


def tp_gather_state_dict(model: torch.nn.Module, grid: ProcessGrid | None = None,
                         grads: bool = False) -> dict[str, torch.Tensor | None]:
    """The single-process state dict of a split ``model``, the same on every
    model rank: each split parameter joined from its model group's slices
    (JAX's ``np.asarray`` of a sharded array). ``grads``: the parameters'
    gradients instead, joined alike (None where a parameter has none)."""
    grid = current_grid() if grid is None else grid
    specs = tp_specs(model, grid.n_model) if grid.n_model > 1 else {}
    if grads:
        tree = {n: None if p.grad is None else p.grad.detach()
                for n, p in model.named_parameters()}
    else:
        tree = model.state_dict()
    out = {}
    for name, t in tree.items():
        if t is not None and name in specs:
            slices = stack_over(t, grid.model_index, grid.n_model, grid.model_group).unbind()
            t = _join(list(slices), specs[name], _packs(name.rsplit(".", 1)[-1]))
        out[name] = t
    return out


def clip_grad_norm_(model: torch.nn.Module, max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over ``model``'s parameters, with
    the norm of the whole model's gradient under a split: each replicated
    gradient counted once (every model rank holds it whole) and the split
    ones' squares summed over the model group. The same max-norm and 1e-6
    as torch's; torch's own call where nothing is split."""
    split = split_parameters(model)
    if not split:
        return torch.nn.utils.clip_grad_norm_(model.parameters(), max_norm)
    grid = next(m.tp for _, m, _, _ in _blocks(model) if getattr(m, "tp", None) is not None)
    ids = {id(p) for p in split}
    whole = [p.grad for p in model.parameters() if p.grad is not None and id(p) not in ids]
    parts = [p.grad for p in split if p.grad is not None]
    first = split[0]
    # every model rank holds the same split parameters, so each joins the all-reduce
    sq = torch.zeros((), dtype=first.dtype, device=first.device)
    if parts:
        sq = torch.stack([torch.linalg.vector_norm(g) for g in parts]).square().sum()
    dist.all_reduce(sq, group=grid.model_group)
    if whole:
        sq = sq + torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in whole])).square()
    total = sq.sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in whole + parts:
        g.mul_(coef.to(g.device, g.dtype))
    return total
