"""The served kernels as ``torch.library`` custom ops, for ``torch.export``.

The kernel wrappers launch through ctypes on ``data_ptr()``, which a
FakeTensor does not have, so ``torch.export`` cannot trace them. While it
traces (``torch.compiler.is_exporting()``), each wrapper on a served path
calls its op here instead, and the exported graph holds an ``objcavit::``
node where the kernel runs:

* ``resize_bilinear_ac`` and ``resize_bilinear_ac_concat``: kernel 1, bare
  and in its concat form (``kernels/resize.py``);
* ``conv_bins_depth_batched``: kernel 2 (``kernels/bins.py``);
* ``attention_fwd``: kernel 5's forward without the residual, on whichever
  route its lengths take, up to 512 keys or past them
  (``kernels/attention.py``);
* ``detect_head``: kernel 6, with ``PackedDetectHead`` passed as its
  tensors and ints (``kernels/detect_head.py``);
* ``se_project``: kernel 7 (``kernels/se_project.py``);
* ``mbconv_head``: kernel 8 (``kernels/mbconv.py``).

Each op's CUDA implementation is its wrapper's launch (the same checks that
raise, the same plan and the same launch counter); its CPU implementation
is the wrapper's plain version; its fake implementation gives the output
shapes and dtypes from the inputs alone. Outside export the wrappers launch
directly, as before, without the dispatcher's cost.

Importing this module registers the ops and builds nothing: nvcc runs at
the first launch. It imports the kernel modules and nothing of the models,
so a process that loads an exported program (``serving_export.py``) needs
this module and not the model code.
"""

from __future__ import annotations

import torch

from objcavit_torch.kernels import attention as kattn
from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import detect_head as kdetect
from objcavit_torch.kernels import mbconv as kmb
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.kernels import se_project as kse

NAMESPACE = "objcavit"
Tensor = torch.Tensor


def _op(name: str):
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(), device_types="cuda")


# ------------------------------------------------------------ kernel 1

@_op("resize_bilinear_ac")
def resize_bilinear_ac(x: Tensor, out_h: int, out_w: int) -> Tensor:
    return kresize.resize_cuda(x, out_h, out_w)


@resize_bilinear_ac.register_kernel("cpu")
def _(x, out_h, out_w):
    # a resize to the input's own size is x itself: an op's output may not alias it
    return kresize.resize_bilinear_align_corners_plain(x, out_h, out_w).clone()


@resize_bilinear_ac.register_fake
def _(x, out_h, out_w):
    return x.new_empty((x.shape[0], out_h, out_w, x.shape[3]))


@_op("resize_bilinear_ac_concat")
def resize_bilinear_ac_concat(x: Tensor, skip: Tensor) -> Tensor:
    return kresize.resize_into_concat_cuda(x, skip)


@resize_bilinear_ac_concat.register_kernel("cpu")
def _(x, skip):
    return kresize.resize_into_concat_plain(x, skip)


@resize_bilinear_ac_concat.register_fake
def _(x, skip):
    return x.new_empty((x.shape[0], skip.shape[1], skip.shape[2], x.shape[3] + skip.shape[3]))


# ------------------------------------------------------------ kernel 2

@_op("conv_bins_depth_batched")
def conv_bins_depth_batched(x: Tensor, kernels: Tensor, bias: Tensor, centers: Tensor) -> Tensor:
    return kbins.conv_bins_depth_batched_cuda(x, kernels, bias, centers)


@conv_bins_depth_batched.register_kernel("cpu")
def _(x, kernels, bias, centers):
    return kbins.conv_bins_depth_batched_plain(x, kernels, bias, centers)


@conv_bins_depth_batched.register_fake
def _(x, kernels, bias, centers):
    return x.new_empty((*x.shape[:3], 1), dtype=torch.float32)


# ------------------------------------------------------------ kernel 5

@_op("attention_fwd")
def attention_fwd(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None) -> Tensor:
    return kattn.fused_mha_fwd(q, k, v, bias, residual=False)[0]


@attention_fwd.register_kernel("cpu")
def _(q, k, v, bias):
    return kattn.mha_fused_plain(q, k, v, bias).contiguous()


@attention_fwd.register_fake
def _(q, k, v, bias):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# ------------------------------------------------------------ kernel 6

@_op("detect_head")
def detect_head(flat: Tensor, wcls: Tensor, bcls: Tensor, w5c: Tensor, b5c: Tensor,
                num_classes: int, nm: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    packed = kdetect.PackedDetectHead(wcls, bcls, w5c, b5c, num_classes, nm)
    return kdetect.fused_detect_head_cuda(flat, packed)


@detect_head.register_kernel("cpu")
def _(flat, wcls, bcls, w5c, b5c, num_classes, nm):
    packed = kdetect.PackedDetectHead(wcls, bcls, w5c, b5c, num_classes, nm)
    out = kdetect.fused_detect_head_plain(flat, packed)
    return tuple(t.contiguous() for t in out)  # y5 and coef are views of one product


@detect_head.register_fake
def _(flat, wcls, bcls, w5c, b5c, num_classes, nm):
    b, s, _ = flat.shape
    a = kdetect.N_ANCHORS
    return (flat.new_empty((b, s, a, kdetect.N_BOX)), flat.new_empty((b, s, a, nm)),
            flat.new_empty((b, s, a), dtype=torch.float32),
            flat.new_empty((b, s, a), dtype=torch.int32))


# ------------------------------------------------------------ kernel 7

@_op("se_project")
def se_project(dw_out: Tensor, gate: Tensor, kernel: Tensor, bias: Tensor,
               skip: Tensor | None) -> Tensor:
    return kse.se_gate_project_cuda(dw_out, gate, kernel, bias, skip)


@se_project.register_kernel("cpu")
def _(dw_out, gate, kernel, bias, skip):
    return kse.se_gate_project_plain(dw_out, gate, kernel, bias, skip)


@se_project.register_fake
def _(dw_out, gate, kernel, bias, skip):
    return dw_out.new_empty((*dw_out.shape[:3], kernel.shape[-1]))


# ------------------------------------------------------------ kernel 8

@_op("mbconv_head")
def mbconv_head(x: Tensor, we: Tensor, be: Tensor, wd: Tensor, bd: Tensor,
                ksize: int) -> tuple[Tensor, Tensor]:
    return kmb.mbconv_expand_dw_pool_cuda(x, we, be, wd, bd, ksize)


@mbconv_head.register_kernel("cpu")
def _(x, we, be, wd, bd, ksize):
    y, pool = kmb.mbconv_expand_dw_pool_plain(x, we, be, wd, bd, ksize)
    return y.contiguous(), pool.contiguous()


@mbconv_head.register_fake
def _(x, we, be, wd, bd, ksize):
    m = we.shape[-1]
    return x.new_empty((*x.shape[:3], m)), x.new_empty((x.shape[0], m), dtype=torch.float32)
