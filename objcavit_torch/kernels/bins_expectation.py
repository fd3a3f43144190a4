"""Kernel 4: softmax over bins and expectation over bin centres, with its
gradient, on materialised logits (the bins head's training route).

CUDA source: ``objcavit_torch/csrc/bins_expectation.cu``, whose forward
replaces ``objcavit_tpu/ops/pallas_bins.py::_fwd_impl`` and whose backward
replaces ``::_bwd``. Both are bound by bytes on the H100; the source note
says how their design answers that.

``fused_bins_depth`` is the counterpart of the JAX package's custom-VJP
function: a ``torch.autograd.Function`` whose forward calls
``bins_expectation_fwd`` and whose backward calls ``bins_expectation_bwd``.
Each of those launches its kernel for CUDA tensors, counts the launch, and
raises on anything the kernel does not take; for CPU tensors it runs its
plain PyTorch version (``bins_expectation_plain``,
``bins_expectation_bwd_plain``). The bins head calls it for bf16 logits
only: an fp32 model on the card takes the plain forward under autograd (the
reference route) and launches no kernel.
"""

from __future__ import annotations

import torch

from objcavit_torch.kernels.build import check_launch, load_library

_FWD = "objcavit_bins_expectation_fwd"
_BWD = "objcavit_bins_expectation_bwd"
N_BINS = 256  # the kernel's bin count: 8 bins for each of a warp's 32 lanes
_ROW_QUANTUM = 32  # rows a block's 8 warps take per step (8 warps x 4 rows)
_BLOCKS_PER_SM = 4  # blocks of 256 threads resident on an SM at its register use


def bins_expectation_plain(logits: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward: fp32 softmax, then the expectation over the
    centres. (B, S, K) logits, (B, K) centers -> (B, S) fp32 depth."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.matmul(probs, centers.float().unsqueeze(-1)).squeeze(-1)


def bins_expectation_bwd_plain(
    logits: torch.Tensor, centers: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward, the formula of ``pallas_bins.py::_bwd_kernel``:
    ``dlogits = p (c - depth) g`` in the logits' dtype and
    ``dcenters = sum_s p g`` in fp32, with p recomputed from the logits."""
    p = torch.softmax(logits.float(), dim=-1)
    c = centers.float().unsqueeze(1)  # (B, 1, K)
    depth = (p * c).sum(-1, keepdim=True)
    gt = g.float().unsqueeze(-1)  # (B, S, 1)
    dlogits = (p * (c - depth) * gt).to(logits.dtype)
    dcenters = (p * gt).sum(1)
    return dlogits, dcenters


def check_bins_expectation_inputs(logits: torch.Tensor, centers: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernels take these arguments."""
    if logits.dim() != 3:
        raise ValueError(f"bins expectation takes logits as (B, S, K), got {tuple(logits.shape)}")
    if logits.dtype != torch.bfloat16 or centers.dtype != torch.float32:
        raise ValueError(
            f"bins expectation takes bf16 logits and fp32 centers, got {logits.dtype} "
            f"and {centers.dtype}"
        )
    b, _, k = logits.shape
    if k != N_BINS or centers.shape != (b, N_BINS):
        raise ValueError(
            f"bins expectation takes K = {N_BINS} bins and centers (B, {N_BINS}), got logits "
            f"{tuple(logits.shape)} and centers {tuple(centers.shape)}"
        )
    if not logits.is_contiguous() or not centers.is_contiguous():
        raise ValueError("bins expectation needs contiguous logits and centers")
    if logits.device != centers.device:
        raise ValueError(f"bins expectation inputs lie on {logits.device} and {centers.device}")
    if logits.data_ptr() % 16 or centers.data_ptr() % 16:
        raise ValueError("bins expectation needs 16-byte aligned logits and centers")


def _rows_per_block(logits: torch.Tensor) -> int:
    """One wave of blocks over the batch, a whole number of steps each."""
    b, s, _ = logits.shape
    n_sm = torch.cuda.get_device_properties(logits.device).multi_processor_count
    blocks_per_image = max(1, -(-_BLOCKS_PER_SM * n_sm // b))
    rows = -(-s // blocks_per_image)
    return max(_ROW_QUANTUM, -(-rows // _ROW_QUANTUM) * _ROW_QUANTUM)


def _device_checked(logits: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on any other device."""
    if logits.device.type == "cpu":
        return False
    if logits.device.type != "cuda":
        raise ValueError(f"bins expectation runs on CUDA tensors, got {logits.device}")
    return True


def bins_expectation_fwd(logits: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, S, 256) bf16 logits, (B, 256) fp32 centers -> (B, S) fp32 depth."""
    if not _device_checked(logits):
        return bins_expectation_plain(logits, centers)
    check_bins_expectation_inputs(logits, centers)
    b, s, _ = logits.shape
    depth = torch.empty((b, s), dtype=torch.float32, device=logits.device)
    rc = getattr(load_library(), _FWD)(
        logits.data_ptr(), centers.data_ptr(), depth.data_ptr(), b, s,
        _rows_per_block(logits), torch.cuda.current_stream(logits.device).cuda_stream,
    )
    check_launch(_FWD, rc)
    bins_expectation_fwd.launches += 1
    return depth


def bins_expectation_bwd(
    logits: torch.Tensor, centers: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (dlogits (B, S, 256) bf16, dcenters (B, 256) fp32) for the
    gradient ``g`` (B, S) fp32 of the depth."""
    if not _device_checked(logits):
        return bins_expectation_bwd_plain(logits, centers, g)
    check_bins_expectation_inputs(logits, centers)
    b, s, _ = logits.shape
    if g.dtype != torch.float32 or g.shape != (b, s) or not g.is_contiguous():
        raise ValueError(f"bins expectation takes g as contiguous fp32 (B, S), got "
                         f"{g.dtype} {tuple(g.shape)}")
    if g.device != logits.device:
        raise ValueError(f"bins expectation inputs lie on {logits.device} and {g.device}")
    rows = _rows_per_block(logits)
    dlogits = torch.empty_like(logits)
    partial = torch.empty((b, -(-s // rows), N_BINS), dtype=torch.float32, device=logits.device)
    rc = getattr(load_library(), _BWD)(
        logits.data_ptr(), centers.data_ptr(), g.data_ptr(), dlogits.data_ptr(),
        partial.data_ptr(), b, s, rows, torch.cuda.current_stream(logits.device).cuda_stream,
    )
    check_launch(_BWD, rc)
    bins_expectation_bwd.launches += 1
    return dlogits, partial.sum(1)


bins_expectation_fwd.launches = 0
bins_expectation_bwd.launches = 0


class BinsExpectation(torch.autograd.Function):
    """depth = sum_k softmax(logits)_k centers_k, with the recomputing
    backward (the JAX package's ``_bins_expectation`` custom VJP)."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(logits, centers)
        return bins_expectation_fwd(logits, centers)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, centers = ctx.saved_tensors
        dlogits, dcenters = bins_expectation_bwd(logits, centers, g.contiguous())
        return dlogits, dcenters.to(centers.dtype)


def fused_bins_depth(logits: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, H, W, K) logits + (B, K) centres -> (B, H, W, 1) fp32 depth."""
    b, h, w, k = logits.shape
    return BinsExpectation.apply(logits.reshape(b, h * w, k), centers).reshape(b, h, w, 1)
