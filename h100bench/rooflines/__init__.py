"""A kernel's operations and bytes, one file a kernel of the program.

Each file names the program's module classes whose forward launches the
kernel (``HOOKS``, "module:Class"), the kernel's kind as the trace names it
(``KIND``, ``h100bench/trace.py::kernel_kind``), and ``launches(module,
args, output)``: the launches that one forward of such a module made, each
a dict of ``bytes`` (each input byte read once, each output byte written
once), ``bf16`` (tensor-core operations) and ``fp32`` (CUDA-core
operations), from the shapes alone. ``h100bench/instrument.py`` hooks them
in the traced window; a roofline share is the launches' least time
(``h100bench/peaks.py``) over the kernel's device time there.
"""
