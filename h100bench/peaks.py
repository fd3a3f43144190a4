"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit): HBM bytes a second, bf16 tensor-core and fp32 CUDA-core
operations a second."""

HBM_BYTES_PER_S = 3.35e12
BF16_PER_S = 989e12
FP32_PER_S = 67e12


def bound_s(nbytes: float, bf16: float = 0.0, fp32: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations' time (tensor and CUDA cores run at once,
    so the larger of their two times). -> (seconds, what bounds it)."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = max(bf16 / BF16_PER_S, fp32 / FP32_PER_S)
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"
