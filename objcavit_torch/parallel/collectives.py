"""What makes N processes' train step the single-process step on the global batch.

The JAX package's sharded train step is one program over the global batch:
XLA sums across the mesh wherever the arithmetic reads the whole batch. In
a process group of more than one process the port does the same by hand, at
each place that reads the batch as a whole:

* ``global_sum``: a sum over the global batch, the all-reduce of each
  rank's sum through ``torch.distributed.nn.functional.all_reduce``, which
  carries gradients. The losses (SILog's sums and pixel count, the chamfer's
  row sums and row count, the MSE's sum and count) and the metrics' batch
  sums go through it;
* ``global_max``: the largest of a value over the ranks: ObjCAViT's
  object front-pad starts at S - n_b, n_b the batch's largest count of
  valid objects (``models/objcavit.py``), which every rank must take from
  the global batch, in training and in evaluation alike;
* ``batch_norm``: a train-mode BatchNorm over the global batch's statistics
  (``models/common.py::BatchNorm2d``), as ``torch.nn.SyncBatchNorm`` takes
  them: one collective forward, every rank's (count, mean, sum of squared
  deviations) gathered and merged by Chan's formula, and one backward, the
  global sums of dy and dy (x - mean); PyTorch's running-statistics rule
  (momentum, or the cumulative average when it is None; the unbiased
  variance);
* ``rand_rows``: the random numbers of the device augmentation, the
  dropout and the stochastic depth. Every rank draws the global batch's
  numbers from its generator (one seed on every rank) and keeps its rows
  ``[p::P]``, so the masks are the single-process run's and two ranks never
  share one;
* ``GradientReducer``: after the backward, the mean over the ranks of
  each parameter's gradient, all-reduced in flat buckets. Every rank
  computes the same global loss and backpropagates it, so the all-reduce
  inside ``global_sum`` hands each rank ``P`` times its rows' share of the
  gradient: the mean over the ranks is the global batch's gradient, not
  ``P`` times it.

Inside a group of more than one process every rank must run the same
forwards, since each takes part in these collectives: the entry points
join a group only to train (``cli.main``; ``-v`` and ``-i`` refuse more
than one process). At a world of one (no group, or a group of one)
``global_sum``, ``global_max``, ``batch_norm`` and ``rand_rows`` take the
single-process code unchanged, and the reducer reduces nothing.

Under a process grid (``parallel/mesh.py``) the ranks of one model group
hold the same rows, so every one of these reads the batch over the data
group alone: the sums, the max, the BatchNorm statistics, the draws' rows
(``[d::n_data]``, d the data index) and the gradient mean (a replicated
parameter's over every rank, ``GradientReducer``). Without a grid the data
group is the whole group. Two collectives serve the model axis,
Megatron's conjugate operators around a split block (``parallel/tp.py``):
``copy_to_model`` (the identity forward, the all-reduce of the gradient
over the model group backward) on the block's input, and
``reduce_from_model`` (the all-reduce of the partial products forward, the
identity backward) on its output.

``GradientReducer`` stands where ``DistributedDataParallel`` would: the
train step runs the model through ``torch.func.functional_call`` on bf16
copies of the parameters (``GraphBins.params_in``), a forward DDP's own
``forward`` never sees; and the object branch of the last cross-attention
gets no gradient on any rank (nothing reads it), which the reducer leaves
as None, as a single process does, where DDP would need
``find_unused_parameters``. Its buckets are flat copies in
``named_parameters`` order, so the channels_last conv weights' strides do
not matter to them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from objcavit_torch.parallel.distributed import process_count
from objcavit_torch.parallel.mesh import current_grid

BUCKET_BYTES = 25 * 2**20  # a gradient bucket's size, DDP's default


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group's ranks, with its gradient (the
    identity where the data axis is one rank)."""
    grid = current_grid()
    if grid.n_data == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=grid.data_group)


def global_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise largest of ``t`` over the data group's ranks, without
    a gradient (``t`` itself where the data axis is one rank)."""
    grid = current_grid()
    if grid.n_data == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=grid.data_group)
    return t


def rand_rows(shape, generator: torch.Generator | None, device, dim: int = 0,
              block: tuple[int, int] | None = None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows of the global batch along
    ``dim``: the global draw, ``shape[dim] * n_data`` rows, from
    ``generator``, then rows ``[d::n_data]``. ``block`` (i, n): ``shape``'s
    last dim is block i of the n equal blocks of the global draw's last dim
    (a model rank's columns of a split FFN). Where there is one data rank
    and no block, the draw itself."""
    grid = current_grid()
    if grid.n_data == 1 and block is None:
        return torch.rand(shape, generator=generator, device=device)
    full = list(shape)
    full[dim] *= grid.n_data
    if block is not None:
        full[-1] *= block[1]
    u = torch.rand(full, generator=generator, device=device)
    if grid.n_data > 1:
        u = u[(slice(None),) * dim + (slice(grid.data_index, None, grid.n_data),)]
    if block is not None:
        u = u[..., block[0] * shape[-1]:(block[0] + 1) * shape[-1]]
    return u


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` itself forward; backward, the gradient summed
    over the model ``group`` (each rank's heads or FFN columns give their
    part of the input's gradient)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over the model ``group`` forward (each
    rank's partial product of a row-split weight); the gradient itself
    backward."""
    return _ReduceFromModel.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def batch_norm(bn: torch.nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``bn`` in training mode on NCHW ``x``, normalised with the global
    batch's statistics (in fp32 or wider), its running statistics updated
    as PyTorch's BatchNorm updates them; the output in x's dtype."""
    return _GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn)


def stack_over(t: torch.Tensor, index: int, n: int, group) -> torch.Tensor:
    """The ``n`` ranks of ``group``'s ``t`` (one shape on each), stacked in
    the order of their ``index``: one all-reduce of a zeroed (n, ...) tensor
    holding this rank's ``t``, a collective of NCCL and of gloo on CUDA
    tensors as well as CPU ones."""
    stack = t.new_zeros((n,) + tuple(t.shape))
    stack[index] = t
    dist.all_reduce(stack, group=group)
    return stack


def _gather_rows(row: torch.Tensor, grid=None) -> torch.Tensor:
    """Every data rank's ``row``, stacked in data-index order."""
    grid = current_grid() if grid is None else grid
    return stack_over(row, grid.data_index, grid.n_data, grid.data_group)


def gather_data(x: torch.Tensor, grid=None) -> torch.Tensor:
    """Every data rank's ``x`` (the same shape on each), joined along dim 0
    in data-index order (``x`` itself where the data axis is one rank), over
    ``grid``'s data axis (the process's grid if None)."""
    grid = current_grid() if grid is None else grid
    if grid.n_data == 1:
        return x
    return _gather_rows(x.reshape(-1), grid).reshape((grid.n_data * x.shape[0],) + x.shape[1:])


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the ranks' rows together. Saves x in its
    own dtype; the statistics and the sums run in ``acc``, fp32 or wider."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        acc = torch.promote_types(x.dtype, torch.float32)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        c = x.shape[1]
        xa = x.to(acc)
        var, mean = torch.var_mean(xa, dims, correction=0)
        n = float(x.numel() // c)
        rows = _gather_rows(torch.cat([mean, var * n, mean.new_full((1,), n)]))
        means, m2s, counts = rows[:, :c], rows[:, c:2 * c], rows[:, 2 * c:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (m2s.sum(0) + (counts * (means - mean) ** 2).sum(0)) / total
        if bn.track_running_stats:
            bn.num_batches_tracked.add_(1)
            f = 1.0 / float(bn.num_batches_tracked) if bn.momentum is None else bn.momentum
            bn.running_mean.mul_(1.0 - f).add_(mean, alpha=f)
            bn.running_var.mul_(1.0 - f).add_(var * (total / (total - 1)), alpha=f)
        invstd = torch.rsqrt(var + bn.eps)
        y = (xa - mean.view(shape)) * invstd.view(shape)
        if weight is not None:
            y = y * weight.to(acc).view(shape) + bias.to(acc).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.total = total
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        acc = mean.dtype
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xmu = x.to(acc) - mean.view(shape)
        dy = dy.to(acc)
        sums = torch.stack([dy.sum(dims), (dy * xmu).sum(dims)])  # this rank's
        grad_w = grad_b = None
        if weight is not None:
            grad_w = (sums[1] * invstd).to(weight.dtype)
            grad_b = sums[0].to(weight.dtype)
        sums = sums.clone()
        dist.all_reduce(sums, group=current_grid().data_group)
        sum_dy, sum_dy_xmu = (sums / ctx.total).unbind()
        scale = invstd if weight is None else invstd * weight.to(acc)
        dx = (dy - sum_dy.view(shape)
              - xmu * (invstd * invstd * sum_dy_xmu).view(shape)) * scale.view(shape)
        return dx.to(x.dtype), grad_w, grad_b, None


class GradientReducer:
    """``reducer()`` after the backward: every parameter's gradient becomes
    its mean over the data group's ranks (nothing to do at a world of one).
    Under a grid split over its model axis (``parallel/tp.py``), a split
    parameter's gradient (its ``tp_dim`` set) is its mean over the data
    group alone: the model ranks hold other slices, whose gradients differ
    by design. A replicated parameter's gradient is its mean over every
    rank: each model rank computed the same data-rank gradient, equal in
    exact arithmetic, but kernels that sum in any order (cuDNN's backward
    convs) round them apart, and the model ranks' copies of the parameter
    would drift apart from the first update (an H100 read two ranks' losses
    apart at the second step); the mean over the model ranks makes them one.
    Parameters without a gradient keep None; every rank must have the same
    such set, which one small all-reduce of the set's mask (its largest and
    smallest over the ranks) checks at the first call and whenever the set
    changes: a mismatch raises instead of mixing gradients or hanging in a
    bucket."""

    def __init__(self, params):
        if not dist.is_initialized():
            raise RuntimeError("GradientReducer needs a process group")
        self.params = list(params)
        self.backend = dist.get_backend()
        self._checked: tuple | None = None  # the set of parameters with a gradient

    def __call__(self) -> None:
        grid = current_grid()
        world = grid.n_data * grid.n_model  # the grid spans the whole group
        if world == 1 or not self.params:
            return
        # the check runs on a rank without any gradient too: its peers wait
        # in the check's all-reduce
        layout = tuple(p.grad is not None for p in self.params)
        if layout != self._checked:
            mask = torch.tensor(layout, dtype=torch.float64, device=self.params[0].device)
            spread = torch.cat([mask, -mask])
            # the largest, minus the smallest
            dist.all_reduce(spread, op=dist.ReduceOp.MAX)
            differ = (spread[:mask.numel()] + spread[mask.numel():]).nonzero().flatten()
            if differ.numel():
                i = int(differ[0])
                raise RuntimeError(f"rank {dist.get_rank()}: the ranks differ on which "
                                   f"parameters have a gradient ({differ.numel()} of "
                                   f"{mask.numel()}, the first #{i}, on this rank "
                                   f"{'with' if layout[i] else 'without'} one)")
            self._checked = layout
        grads = [(p.grad, getattr(p, "tp_dim", None) is not None) for p in self.params
                 if p.grad is not None]
        self._mean([g for g, split in grads if not split], dist.group.WORLD, world)
        if grid.n_data > 1:
            self._mean([g for g, split in grads if split], grid.data_group, grid.n_data)

    def _mean(self, grads, group, n: int) -> None:
        """Each of ``grads`` its mean over the ``n`` ranks of ``group``, in place."""
        for bucket in self._buckets(grads):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view(g.shape))
                offset += g.numel()

    def _buckets(self, grads):
        bucket, size = [], 0
        for g in grads:
            if bucket and (g.dtype != bucket[0].dtype
                           or size + g.numel() * g.element_size() > BUCKET_BYTES):
                yield bucket
                bucket, size = [], 0
            bucket.append(g)
            size += g.numel() * g.element_size()
        if bucket:
            yield bucket


def all_ranks_true(flag: bool, device) -> bool:
    """Whether ``flag`` holds on every rank (True without a group)."""
    if process_count() == 1:
        return flag
    t = torch.tensor(1.0 if flag else 0.0, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t > 0)


def broadcast_from_main(obj, device):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


def barrier() -> None:
    """Wait for every rank, where there is a group."""
    if dist.is_initialized():
        dist.barrier()
