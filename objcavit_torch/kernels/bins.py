"""Kernels 2 and 3: 1x1 conv, softmax over bins, expectation, in one pass.

CUDA source: ``objcavit_torch/csrc/bins_depth.cu``: a persistent grid of one
block an SM over units of (image, 64-pixel tile), TMA loads, ``wgmma`` and
three consumer warpgroups; the source note says what bounds it on the H100
and how the design answers that. ``ring_plan`` picks its ring of stages and
its consumers, which the wrapper passes to the C entry point.

* Kernel 2, ``conv_bins_depth_batched``, one (C, K) weight per image:
  replaces ``objcavit_tpu/ops/pallas_bins.py::fused_conv_bins_depth_batched``,
  the factored bins head of inference.
* Kernel 3, ``conv_bins_depth``, one (C, K) weight for the whole batch:
  replaces ``::fused_conv_bins_depth``, the unfactored bins head of
  inference. It is the same CUDA kernel launched with a weight batch stride
  of 0, and it counts its own launches.

Each wrapper launches the kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it runs its plain PyTorch version. The
kernel has no backward, so a wrapper also raises, on any device, when
autograd would need its gradient. The bins heads call them for bf16 outside
training only: an fp32 model on the card takes the plain version there
(``ops/bins.py``), the reference route, and launches no kernel.
"""

from __future__ import annotations

import torch

from objcavit_torch.kernels.build import check_launch, load_library

_ENTRY = "objcavit_conv_bins_depth_batched"
N_BINS = 256  # the kernel's fixed bin count: two wgmma halves of 128
MAX_CHANNELS = 256  # W and the x ring must fit a block's shared memory
UNIT_PIXELS = 64  # pixels of one unit: wgmma's M
CONSUMERS = 3  # consumer warpgroups of a block (csrc/bins_depth.cu kConsumers)
_SMEM_MAX = 232448  # shared memory a block may use
# alignment slack, then the bias, bias log2 e and centres (fp32) and 18 barriers
# (csrc/bins_depth.cu smem_bytes)
_SMEM_HEAD = 1024 + 3 * N_BINS * 4 + 18 * 8


def ring_plan(c: int) -> tuple[int, int]:
    """(stages of the x ring, consumer warpgroups that take units) at C
    channels, which the wrapper passes to the C entry point (it refuses a
    plan that does not fit): as many 64-pixel x tiles of C channels (in
    64-channel boxes) as shared memory holds beside W, at most 8; and no
    more consumers than stages, since a consumer waits on a stage's fill by
    parity and must not run two fills ahead."""
    stage = -(-c // 64) * UNIT_PIXELS * 64 * 2
    stages = min(8, (_SMEM_MAX - _SMEM_HEAD - c * N_BINS * 2) // stage)
    return stages, min(CONSUMERS, stages)


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
    if x.data_ptr() % 16 or kernels.data_ptr() % 16 or centers.data_ptr() % 16:
        raise ValueError("bins kernel needs 16-byte aligned x, W and centers")


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise RuntimeError if autograd would need the gradient of a
    forward-only kernel's output."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only kernel, but autograd needs its gradient here "
            "(grad mode is on and an input requires grad): run it under torch.no_grad() "
            "or take the differentiable route"
        )


def _launch(x: torch.Tensor, kernels: torch.Tensor, bias: torch.Tensor,
            centers: torch.Tensor) -> torch.Tensor:
    check_bins_inputs(x, kernels, bias, centers)
    b, h, w, c = x.shape
    # a persistent grid: one block an SM
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    depth = torch.empty((b, h, w, 1), dtype=torch.float32, device=x.device)
    rc = getattr(load_library(), _ENTRY)(
        x.data_ptr(), kernels.data_ptr(), bias.data_ptr(), centers.data_ptr(),
        depth.data_ptr(), b, h * w, c, kernels.stride(0), n_sm, *ring_plan(c),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(_ENTRY, rc)
    return depth


def conv_bins_depth_batched(
    x: torch.Tensor, kernels: torch.Tensor, bias: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """Kernel 2. depth[b,h,w] = sum_k softmax_k(x[b,h,w] @ kernels[b] + bias)_k * centers[b,k].

    x (B, H, W, C) bf16, kernels (B, C, 256) bf16, bias (256,) fp32,
    centers (B, 256) fp32 -> (B, H, W, 1) fp32. While ``torch.export``
    traces, the custom op ``objcavit::conv_bins_depth_batched``.
    """
    check_no_grad("conv_bins_depth_batched", x, kernels, bias, centers)
    if torch.compiler.is_exporting():
        from objcavit_torch.kernels import ops
        return ops.conv_bins_depth_batched(x, kernels, bias, centers)
    if x.device.type == "cpu":
        return conv_bins_depth_batched_plain(x, kernels, bias, centers)
    if x.device.type != "cuda":
        raise ValueError(f"bins kernel runs on CUDA tensors, got {x.device}")
    return conv_bins_depth_batched_cuda(x, kernels, bias, centers)


def conv_bins_depth_batched_cuda(x, kernels, bias, centers) -> torch.Tensor:
    """Kernel 2's launch on CUDA tensors: its checks, the kernel, the count."""
    depth = _launch(x, kernels, bias, centers)
    conv_bins_depth_batched.launches += 1
    return depth


def conv_bins_depth_plain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of kernel 3: kernel 2's with the weight shared."""
    return conv_bins_depth_batched_plain(x, kernel.expand(x.shape[0], *kernel.shape), bias, centers)


def conv_bins_depth(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """Kernel 3. depth[b,h,w] = sum_k softmax_k(x[b,h,w] @ kernel + bias)_k * centers[b,k].

    x (B, H, W, C) bf16, kernel (C, 256) bf16 contiguous, bias (256,) fp32,
    centers (B, 256) fp32 -> (B, H, W, 1) fp32.
    """
    check_no_grad("conv_bins_depth", x, kernel, bias, centers)
    if x.device.type == "cpu":
        return conv_bins_depth_plain(x, kernel, bias, centers)
    if x.device.type != "cuda":
        raise ValueError(f"bins kernel runs on CUDA tensors, got {x.device}")
    if kernel.dim() != 2:
        raise ValueError(f"bins kernel 3 takes one (C, K) weight, got {tuple(kernel.shape)}")
    depth = _launch(x, kernel.expand(x.shape[0], *kernel.shape), bias, centers)
    conv_bins_depth.launches += 1
    return depth


conv_bins_depth_batched.launches = 0
conv_bins_depth.launches = 0
