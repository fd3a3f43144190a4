"""Kernels 8, 9 and 10: the fused MBConv head, one CUDA kernel in three forms.

CUDA source: ``objcavit_torch/csrc/mbconv_head.cu``. It is bound by bytes on
the H100; the source note says how its design answers that.

* Kernel 8, ``mbconv_expand_dw_pool``: ``silu(dw(silu(x @ we + be)) + bd)``
  and its spatial sum on NHWC tensors; replaces
  ``objcavit_tpu/ops/mbconv_pallas.py::mbconv_expand_dw_pool``, the MBConv
  body of ``EfficientNetEncoder(fused_mbconv_head=True)``.
* Kernel 9, ``mbconv_bs_expand_dw_pool``: the same on (H, W, B, C) tensors;
  replaces ``objcavit_tpu/ops/mbconv_bs.py::mbconv_bs_expand_dw_pool``. The
  kernel reads and writes through strides, so only they differ.
* Kernel 10, ``dw_conv_silu_pool``: ``silu(dw(x) + b)`` and, optionally, its
  spatial sum: the kernel without the expand; replaces
  ``objcavit_tpu/ops/dw_pallas.py::dw_conv_silu_pool``.

Each wrapper has the JAX function's name, arguments and layouts (``we``
(Cin, M), ``wd`` (k, k, 1, M), any (k, k, ...) form of it, or the packed
(k*k, M)), its own ``launches`` counter and a plain PyTorch version beside
it, which rounds where the TPU kernel does: the weights to the input's dtype, the expanded
band to the input's dtype before the depthwise (the zero padding of the
band is zero, not ``silu(be)``), ``y`` to the input's dtype once; the pool
is the sum of the fp32 ``y``. A wrapper launches the kernel for CUDA tensors
and raises on anything the kernel does not take (bf16 activations and
weights, fp32 biases, contiguous tensors, Cin and M multiples of 8, k 3 or
5); for CPU tensors it runs the plain version. The kernel has no backward,
so a wrapper raises when autograd would need its gradient.
``pack_mbconv`` lays a block's expand and depthwise convs out as the kernel
reads them; the encoder makes it once per set of weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from objcavit_torch.kernels.bins import check_no_grad
from objcavit_torch.kernels.build import check_launch, load_library

_ENTRY = "objcavit_mbconv_head"
KSIZES = (3, 5)
TILE_H, TILE_W = 8, 16  # the kernel's output tile
CHANNEL_ALIGN = 8  # Cin and M: 16-byte rows of bf16


def mbconv_eligible(cin: int, m: int, ksize: int, stride: int) -> bool:
    """Whether the kernel takes a block of these widths (any H and W)."""
    return (stride == 1 and ksize in KSIZES and cin % CHANNEL_ALIGN == 0
            and m % CHANNEL_ALIGN == 0)


@dataclass(frozen=True)
class PackedMBConv:
    """A block's expand and depthwise convs as the kernel reads them."""

    we: torch.Tensor  # (Cin, M) model dtype
    be: torch.Tensor  # (M,) fp32
    wd: torch.Tensor  # (k*k, M) model dtype
    bd: torch.Tensor  # (M,) fp32
    ksize: int


@torch.no_grad()
def pack_mbconv(expand_weight, expand_bias, dw_weight, dw_bias) -> PackedMBConv:
    """(M, Cin, 1, 1), (M,), (M, 1, k, k), (M,) conv tensors -> PackedMBConv."""
    m, k = dw_weight.shape[0], dw_weight.shape[-1]
    return PackedMBConv(
        expand_weight.reshape(m, -1).t().contiguous(), expand_bias.float().contiguous(),
        dw_weight.reshape(m, k * k).t().contiguous(), dw_bias.float().contiguous(), k,
    )


def _taps(wd: torch.Tensor, ksize: int) -> torch.Tensor:
    """Any (k, k, ...) form of the depthwise weight -> (k*k, M)."""
    return wd.reshape(ksize * ksize, -1)


def expand_plain(x: torch.Tensor, we: torch.Tensor, be: torch.Tensor) -> torch.Tensor:
    """fp32 ``silu(x @ we + be)`` of (B, H, W, Cin) x, before its rounding:
    the products of x and the weight in x's dtype, summed in fp32."""
    e = torch.matmul(x.float(), we.to(x.dtype).float()) + be.float()
    return F.silu(e)


def depthwise_silu_plain(e: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                         ksize: int) -> torch.Tensor:
    """fp32 ``silu(dw(e) + bd)`` of (B, H, W, M) e with the weight rounded to
    e's dtype: SAME zero padding, stride 1, an fp32 convolution."""
    m = e.shape[-1]
    weight = _taps(wd, ksize).to(e.dtype).float().t().reshape(m, 1, ksize, ksize)
    z = F.conv2d(e.float().permute(0, 3, 1, 2), weight, padding=ksize // 2, groups=m)
    return F.silu(z + bd.float()[:, None, None]).permute(0, 2, 3, 1)


def mbconv_expand_dw_pool_plain(x, we, be, wd, bd, ksize: int):
    """Plain PyTorch version of kernel 8: (y (B, H, W, M) in x's dtype,
    pool (B, M) fp32)."""
    y = depthwise_silu_plain(expand_plain(x, we, be).to(x.dtype), wd, bd, ksize)
    return y.to(x.dtype), y.sum((1, 2))


def mbconv_bs_expand_dw_pool_plain(x_t, we, be, wd, bd, ksize: int):
    """Plain PyTorch version of kernel 9: kernel 8's on (H, W, B, Cin),
    giving (y (H, W, B, M), pool (B, M) fp32)."""
    y, pool = mbconv_expand_dw_pool_plain(x_t.permute(2, 0, 1, 3), we, be, wd, bd, ksize)
    return y.permute(1, 2, 0, 3).contiguous(), pool


def dw_conv_silu_pool_plain(x, w, b, ksize: int, with_pool: bool = True):
    """Plain PyTorch version of kernel 10: (y (B, H, W, C) in x's dtype,
    pool (B, C) fp32 or None)."""
    y = depthwise_silu_plain(x, w, b, ksize)
    return y.to(x.dtype), (y.sum((1, 2)) if with_pool else None)


def check_mbconv_inputs(x, we, be, wd, bd, ksize: int, expand: bool) -> None:
    """Raise ValueError unless the CUDA kernel takes these arguments: x
    (4-D, channels last and contiguous), we (Cin, M) when ``expand``."""
    if x.dim() != 4:
        raise ValueError(f"mbconv kernel takes a 4-D x, got {tuple(x.shape)}")
    cin = x.shape[3]
    m = we.shape[-1] if expand else cin
    tensors = [x, wd, bd] + ([we, be] if expand else [])
    if x.dtype != torch.bfloat16 or wd.dtype != torch.bfloat16 \
            or (expand and we.dtype != torch.bfloat16):
        raise ValueError(f"mbconv kernel takes bf16 x and weights, got {x.dtype}, "
                         f"{wd.dtype}{f' and {we.dtype}' if expand else ''}")
    if bd.dtype != torch.float32 or (expand and be.dtype != torch.float32):
        raise ValueError("mbconv kernel takes fp32 biases")
    if ksize not in KSIZES:
        raise ValueError(f"mbconv kernel takes k in {KSIZES}, got {ksize}")
    if cin % CHANNEL_ALIGN or m % CHANNEL_ALIGN or not cin or not m:
        raise ValueError(f"mbconv kernel needs Cin and M multiples of {CHANNEL_ALIGN}, "
                         f"got Cin={cin}, M={m}")
    if expand and we.shape != (cin, m):
        raise ValueError(f"mbconv kernel takes we as (Cin, M) = {(cin, m)}, got {tuple(we.shape)}")
    taps = tuple(wd.shape[:2]) == (ksize, ksize) or tuple(wd.shape) == (ksize * ksize, m)
    if not taps or wd.numel() != ksize * ksize * m:
        raise ValueError(f"mbconv kernel takes wd as ({ksize}, {ksize}, ..., {m}) or "
                         f"({ksize * ksize}, {m}), got {tuple(wd.shape)}")
    if bd.shape != (m,) or (expand and be.shape != (m,)):
        raise ValueError(f"mbconv kernel takes biases of ({m},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mbconv kernel needs contiguous x, weights and biases")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"mbconv kernel inputs lie on several devices: {devices}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("mbconv kernel needs 16-byte aligned inputs")


def _launch(x, we, be, wd, bd, ksize: int, expand: bool, with_pool: bool, batch_minor: bool):
    """Launch on x (B, H, W, Cin), or (H, W, B, Cin) with ``batch_minor``."""
    check_mbconv_inputs(x, we, be, wd, bd, ksize, expand)
    if batch_minor:
        h, w, b, cin = x.shape
    else:
        b, h, w, cin = x.shape
    m = we.shape[1] if expand else cin
    y = torch.empty((*x.shape[:3], m), dtype=x.dtype, device=x.device)
    # element strides of an image, a row and a column, for x and for y
    strides = [(c, w * b * c, b * c) if batch_minor else (h * w * c, w * c, c) for c in (cin, m)]
    n_tiles = -(-h // TILE_H) * -(-w // TILE_W)
    partial = pool = None
    if with_pool:
        partial = torch.empty((n_tiles, b, m), dtype=torch.float32, device=x.device)
        pool = torch.empty((b, m), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = getattr(load_library(), _ENTRY)(
        x.data_ptr(), ptr(we) if expand else None, ptr(be) if expand else None, wd.data_ptr(),
        bd.data_ptr(), y.data_ptr(), ptr(partial), ptr(pool), b, h, w, cin, m, ksize,
        *strides[0], *strides[1], int(expand), int(with_pool),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(_ENTRY, rc)
    return y, pool


def _route(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> bool:
    """True for a CUDA launch, False for the plain version on the CPU."""
    check_no_grad(name, x, *tensors)
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    return True


def mbconv_expand_dw_pool(x, we, be, wd, bd, ksize: int):
    """Kernel 8. x (B, H, W, Cin) bf16, we (Cin, M) bf16, be (M,) fp32, wd
    (k, k, 1, M) bf16, bd (M,) fp32 -> (y (B, H, W, M) bf16, pool (B, M)
    fp32): ``silu(dw(silu(x @ we + be)) + bd)``, SAME, stride 1, and its
    spatial sum."""
    if not _route("mbconv_expand_dw_pool", x, we, be, wd, bd):
        return mbconv_expand_dw_pool_plain(x, we, be, wd, bd, ksize)
    out = _launch(x, we, be, wd, bd, ksize, expand=True, with_pool=True, batch_minor=False)
    mbconv_expand_dw_pool.launches += 1
    return out


def mbconv_bs_expand_dw_pool(x_t, we, be, wd, bd, ksize: int):
    """Kernel 9. Kernel 8 on x_t (H, W, B, Cin) -> (y (H, W, B, M), pool
    (B, M) fp32)."""
    if not _route("mbconv_bs_expand_dw_pool", x_t, we, be, wd, bd):
        return mbconv_bs_expand_dw_pool_plain(x_t, we, be, wd, bd, ksize)
    out = _launch(x_t, we, be, wd, bd, ksize, expand=True, with_pool=True, batch_minor=True)
    mbconv_bs_expand_dw_pool.launches += 1
    return out


def dw_conv_silu_pool(x, w, b, ksize: int, with_pool: bool = True):
    """Kernel 10. x (B, H, W, C) bf16, w (k, k, 1, C) bf16, b (C,) fp32 ->
    (y (B, H, W, C) bf16, pool (B, C) fp32, or None without ``with_pool``):
    ``silu(dw(x) + b)``, SAME, stride 1."""
    if not _route("dw_conv_silu_pool", x, w, b):
        return dw_conv_silu_pool_plain(x, w, b, ksize, with_pool)
    out = _launch(x, None, None, w, b, ksize, expand=False, with_pool=with_pool, batch_minor=False)
    dw_conv_silu_pool.launches += 1
    return out


mbconv_expand_dw_pool.launches = 0
mbconv_bs_expand_dw_pool.launches = 0
dw_conv_silu_pool.launches = 0
