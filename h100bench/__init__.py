"""The benchmark of the PyTorch and CUDA port (objcavit_torch) on NVIDIA H100 cards."""
