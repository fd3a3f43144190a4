"""objcavit_torch: the PyTorch and CUDA port of objcavit_tpu, for NVIDIA Hopper.

The JAX package ``objcavit_tpu`` is the reference; this package imports torch
and numpy only. Slice 1 ports the GraphBins-B5 bf16 inference server
(``objcavit_torch.serving``) with its two CUDA kernels
(``objcavit_torch.kernels``).
"""
