"""CUDA kernels of the port, their ctypes bindings and their plain versions."""
