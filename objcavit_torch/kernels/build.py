"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Every ``objcavit_torch/csrc/*.cu`` file exports plain C entry points (device
pointers and the stream as ``void*``). They are compiled together, for
Hopper (``sm_90a``), into one shared library under ``objcavit_torch/_build/``
(a directory git ignores) the first time a kernel is called. A hash of the
sources and flags is stored beside the library, so an edited source rebuilds
and an unchanged one loads at once. Building takes seconds: no source
includes PyTorch's headers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libobjcavit_kernels.so"
STAMP_PATH = BUILD_DIR / "libobjcavit_kernels.sha256"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to a 32-bit int)
SIGNATURES = {
    "objcavit_resize_bilinear_ac_nhwc_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    "objcavit_conv_bins_depth_batched": (
        _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _P,
    ),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build(ptxas_verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into LIB_PATH unless the stored hash matches.

    Returns nvcc's output (empty when nothing was rebuilt); with
    ``ptxas_verbose`` it holds each kernel's registers, shared memory and
    spills. Raises RuntimeError with the compiler's output if nvcc fails.
    """
    digest = sources_hash()
    if LIB_PATH.is_file() and STAMP_PATH.is_file() and STAMP_PATH.read_text() == digest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if ptxas_verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    STAMP_PATH.write_text(digest)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library with every entry point typed."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
