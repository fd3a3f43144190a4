"""objcavit_torch: the PyTorch and CUDA port of objcavit_tpu, for NVIDIA Hopper.

The JAX package ``objcavit_tpu`` is the reference; this package imports torch
and numpy (yaml and PIL for the params files and images), nothing of JAX.
Slice 1 ports the GraphBins-B5 bf16 inference server
(``objcavit_torch.serving``), slice 2 its train step
(``objcavit_torch.training``), slice 3 the fused server with YOLOv7-seg, NMS
and the CLIP class table (``objcavit_torch.serving.FusedDepthPipeline``),
with their CUDA kernels (``objcavit_torch.kernels``). The eval protocol
and the reference CLI's -v/-i entry points are ``objcavit_torch.cli``.
"""
