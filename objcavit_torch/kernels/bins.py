"""Kernel 2: the factored bins head (1x1 conv, softmax over bins, expectation).

CUDA source: ``objcavit_torch/csrc/bins_depth.cu``, which replaces
``objcavit_tpu/ops/pallas_bins.py::fused_conv_bins_depth_batched``. It is
bound by operations on the H100; the source note says how its design answers
that.

``conv_bins_depth_batched`` launches the kernel for CUDA tensors and raises
on anything the kernel does not take; for CPU tensors it runs
``conv_bins_depth_batched_plain``, the plain PyTorch version. The bins head
calls it for bf16 only: an fp32 model on the card takes the plain version
there (``ops/bins.py``), the reference route, and launches no kernel.
"""

from __future__ import annotations

import torch

from objcavit_torch.kernels.build import check_launch, load_library

_ENTRY = "objcavit_conv_bins_depth_batched"
N_BINS = 256  # the kernel's fixed bin count: two passes of 128
MAX_CHANNELS = 256  # W and the x tiles must fit a block's shared memory
_BLOCK_PIXELS = 128  # pixels a block's 8 warps take per step (8 warps x 16)


def conv_bins_depth_batched_plain(
    x: torch.Tensor, kernels: torch.Tensor, bias: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: fp32 logits of the bf16-exact products, fp32
    softmax, expectation over the centres. (B,H,W,C),(B,C,K),(K,),(B,K) ->
    (B,H,W,1) fp32."""
    b, h, w, c = x.shape
    logits = torch.matmul(x.reshape(b, h * w, c).float(), kernels.float()) + bias.float()
    probs = torch.softmax(logits, dim=-1)
    depth = torch.matmul(probs, centers.float().unsqueeze(-1))
    return depth.reshape(b, h, w, 1)


def check_bins_inputs(
    x: torch.Tensor, kernels: torch.Tensor, bias: torch.Tensor, centers: torch.Tensor
) -> None:
    """Raise ValueError unless the CUDA kernel takes these arguments.

    ``kernels`` may be a (C, K) weight expanded to (B, C, K) with a batch
    stride of 0: one W shared by every image.
    """
    if x.dim() != 4:
        raise ValueError(f"bins kernel takes x as (B, H, W, C), got {tuple(x.shape)}")
    b, _, _, c = x.shape
    if x.dtype != torch.bfloat16 or kernels.dtype != torch.bfloat16:
        raise ValueError(f"bins kernel takes bf16 x and W, got {x.dtype} and {kernels.dtype}")
    if bias.dtype != torch.float32 or centers.dtype != torch.float32:
        raise ValueError(
            f"bins kernel takes fp32 bias and centers, got {bias.dtype} and {centers.dtype}"
        )
    if kernels.shape != (b, c, N_BINS):
        raise ValueError(f"bins kernel takes W as (B, C, {N_BINS}), got {tuple(kernels.shape)}")
    if bias.shape != (N_BINS,) or centers.shape != (b, N_BINS):
        raise ValueError(
            f"bins kernel takes bias ({N_BINS},) and centers (B, {N_BINS}), "
            f"got {tuple(bias.shape)} and {tuple(centers.shape)}"
        )
    if c % 16 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"bins kernel needs C % 16 == 0 and C <= {MAX_CHANNELS}, got C={c}")
    if not x.is_contiguous() or not bias.is_contiguous() or not centers.is_contiguous():
        raise ValueError("bins kernel needs contiguous x, bias and centers")
    if not kernels[0].is_contiguous() or kernels.stride(0) not in (0, c * N_BINS):
        raise ValueError("bins kernel needs W contiguous per image, batch stride C*K or 0")
    devices = {t.device for t in (x, kernels, bias, centers)}
    if len(devices) != 1:
        raise ValueError(f"bins kernel inputs lie on several devices: {devices}")
    if x.data_ptr() % 16 or kernels.data_ptr() % 16:
        raise ValueError("bins kernel needs 16-byte aligned x and W")


def conv_bins_depth_batched(
    x: torch.Tensor, kernels: torch.Tensor, bias: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """depth[b,h,w] = sum_k softmax_k(x[b,h,w] @ kernels[b] + bias)_k * centers[b,k].

    x (B, H, W, C) bf16, kernels (B, C, 256) bf16, bias (256,) fp32,
    centers (B, 256) fp32 -> (B, H, W, 1) fp32.
    """
    if x.device.type == "cpu":
        return conv_bins_depth_batched_plain(x, kernels, bias, centers)
    if x.device.type != "cuda":
        raise ValueError(f"bins kernel runs on CUDA tensors, got {x.device}")
    check_bins_inputs(x, kernels, bias, centers)
    b, h, w, c = x.shape
    s = h * w
    # about two blocks per SM over the whole batch; each block stages its
    # image's W once, so fewer, longer blocks amortise that copy
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks_per_image = max(1, -(-2 * n_sm // b))
    pix_per_block = -(-s // blocks_per_image)
    pix_per_block = -(-pix_per_block // _BLOCK_PIXELS) * _BLOCK_PIXELS
    depth = torch.empty((b, h, w, 1), dtype=torch.float32, device=x.device)
    rc = getattr(load_library(), _ENTRY)(
        x.data_ptr(), kernels.data_ptr(), bias.data_ptr(), centers.data_ptr(),
        depth.data_ptr(), b, s, c, kernels.stride(0), pix_per_block,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(_ENTRY, rc)
    conv_bins_depth_batched.launches += 1
    return depth


conv_bins_depth_batched.launches = 0
