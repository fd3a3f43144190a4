"""The controls: the reference computed one precision below the configuration's.

Serving (``Fp8Compute``): the configurations serve in bf16, their weights,
inputs and every operation at bf16 but the bins head; the control is the
reference cast to bf16 with its weights, its inputs and every bf16 result
rounded to fp8 e4m3 (per-tensor scale), the same computation one precision
lower. Training (``Fp8Operands``): the configurations train with bf16
compute; the step below it is fp8, as fp8 training runs it: every product
of the reference (convolutions, linear layers, matmuls and einsums:
attention's scores and values, the range maps) reads its two operands
rounded to float8 e4m3 with a per-tensor scale (amax to e4m3's largest
normal, 448), and computes in fp32 from there; in the backward, the gradient that reaches a product's
output is rounded to float8 e5m2 the same way (amax to 57344) before the
product's two backward products read it, which take the rounded forward
operands saved. Biases, normalisations, softmaxes and the losses stay fp32,
as the program keeps them.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
PRODUCTS = {"conv2d", "linear", "einsum", "matmul", "bmm", "mm", "__matmul__"}


def rounded(t: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """``t``'s finite values rounded to ``dtype`` under a per-tensor scale (an
    infinity, a masked score, stays as it is), no grad."""
    with torch.no_grad():
        finite = torch.isfinite(t)
        scale = torch.where(finite, t.abs(), 0).amax().clamp(min=1e-30) / top
        return torch.where(finite, (t / scale).to(dtype).to(t.dtype) * scale, t)


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, torch.float8_e5m2, E5M2_MAX)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3; the gradient passes to ``t`` as through the
    identity."""
    if not t.is_floating_point():
        return t
    r = rounded(t)
    return t + (r - t).detach() if t.requires_grad else r


class Fp8Operands(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in PRODUCTS:
            if func.__name__ == "einsum":
                args = (args[0],) + tuple(round_fp8(a) if isinstance(a, torch.Tensor) else a
                                          for a in args[1:])
            else:  # the first two operands; a bias stays as it is
                args = tuple(round_fp8(a) if i < 2 and isinstance(a, torch.Tensor) else a
                             for i, a in enumerate(args))
                for key in ("input", "weight", "other"):
                    if isinstance(kwargs.get(key), torch.Tensor):
                        kwargs[key] = round_fp8(kwargs[key])
            out = func(*args, **kwargs)
            return _RoundGrad.apply(out) if out.requires_grad else out
        return func(*args, **kwargs)


class Fp8Compute(TorchFunctionMode):
    """While active, every bf16 result of every operation is rounded to
    e4m3 (per-tensor scale) and back: the serving control runs the bf16
    reference, its parameters rounded so (``round_parameters_``), inside."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16:
            return rounded(out)
        return out


def round_parameters_(model: torch.nn.Module) -> torch.nn.Module:
    """Every bf16 parameter and buffer of ``model`` rounded to e4m3, in place."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.dtype == torch.bfloat16:
                t.copy_(rounded(t))
    return model
