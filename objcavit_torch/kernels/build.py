"""Build the package's CUDA kernels with nvcc and its host core with g++,
and bind them with ctypes.

Every ``objcavit_torch/csrc/*.cu`` file exports plain C entry points (device
pointers and the stream as ``void*``); ``csrc/*.cuh`` holds device helpers
that some of them include. The first time a kernel is called, each source
is compiled for Hopper (``sm_90a``) by its own nvcc process, all started
together, and the objects are linked into one shared library under
``objcavit_torch/_build/`` (a directory git ignores). A hash of the
sources, headers and flags is stored beside the library, so an edited
source rebuilds and an unchanged one loads at once. Building takes
seconds: no source includes PyTorch's headers.

The host core, ``csrc/preprocess.cpp`` (the data loader's rotations,
augmentation and batch assembly; ``data/native.py`` binds it), is built the
same way by ``build_host`` with the C++ compiler (``$CXX``, else g++) and
the JAX package's ``csrc/Makefile`` flags, into
``_build/libobjcavit_preprocess.so``. ``-march=native`` ties that library
to the CPU it was built on, so its stamp also names the CPU: a tree carried
to another machine rebuilds instead of dying on an illegal instruction.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libobjcavit_kernels.so"
STAMP_PATH = BUILD_DIR / "libobjcavit_kernels.sha256"

HOST_SOURCE = CSRC_DIR / "preprocess.cpp"
HOST_LIB_PATH = BUILD_DIR / "libobjcavit_preprocess.so"
# csrc/Makefile's flags: with the same compiler, the port's core computes the
# JAX package's bits
HOST_CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17",
                  "-pthread")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
# C entry point -> argument types (pointers and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to a 32-bit int)
SIGNATURES = {
    "objcavit_resize_bilinear_ac_nhwc_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "objcavit_resize_bilinear_ac_concat_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "objcavit_resize_bilinear_ac_window_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P,
    ),
    "objcavit_conv_bins_depth_batched": (
        _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _P,
    ),
    "objcavit_bins_expectation_fwd": (_P, _P, _P, _I, _I, _I, _P),
    "objcavit_bins_expectation_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "objcavit_detect_head": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    "objcavit_attention_fwd": (_P, _P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _F, _I, _I, _P),
    "objcavit_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _F,
                               _IP, _P),
    "objcavit_attention_bwd_clusters": (_I, _I, _I, _I, _IP),
    "objcavit_attention_long_fwd_blocks": (_I, _I, _IP),
    "objcavit_mbconv_head": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, _LL, _P),
    "objcavit_mbconv_head_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, _LL,
                                  _I, _I, _P),
    "objcavit_dw_silu_pool": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P),
    "objcavit_se_project": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def cpu_info() -> dict[str, str]:
    """The first core's fields of /proc/cpuinfo ({} where there is none)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n")[0].splitlines()
    except OSError:
        return {}
    return dict((k.strip(), v.strip()) for k, v in (line.split(":", 1) for line in lines
                                                    if ":" in line))


# the /proc/cpuinfo fields that name a CPU and its features (x86's, then
# Arm's); a virtual machine may give "unknown" for the model name
CPU_FIELDS = ("vendor_id", "cpu family", "model", "model name", "flags", "CPU implementer",
              "CPU architecture", "CPU variant", "CPU part", "Features")


def host_cpu() -> str:
    """The CPU that ``-march=native`` builds for: the machine's architecture
    and the first core's ``CPU_FIELDS``, or the platform's name for it
    where there is no /proc/cpuinfo."""
    info = cpu_info()
    if not info:
        return platform.processor() or platform.machine()
    return "; ".join([platform.machine()] + [f"{k}: {info[k]}" for k in CPU_FIELDS if k in info])


def host_command(lib_path: Path) -> list[str]:
    """The compiler line that builds the host core into ``lib_path``."""
    return [os.environ.get("CXX") or "g++", *HOST_CXX_FLAGS, "-o", str(lib_path),
            str(HOST_SOURCE)]


def build_host(lib_path: Path | None = None) -> str:
    """Compile ``csrc/preprocess.cpp`` into ``lib_path`` (default
    ``HOST_LIB_PATH``) unless the stamp beside it (a hash of the compiler
    line, the source and ``host_cpu()``) matches. Returns the compiler line
    ('' when nothing was rebuilt). Builds in a temporary directory and
    renames the result into place, so two processes that build at once each
    see a whole library. Raises RuntimeError with the compiler's output if
    it fails or cannot be run."""
    lib_path = Path(HOST_LIB_PATH if lib_path is None else lib_path)
    stamp = lib_path.with_suffix(".sha256")
    cmd = host_command(lib_path)
    h = hashlib.sha256(" ".join(cmd).encode())
    h.update(HOST_SOURCE.read_bytes())
    h.update(host_cpu().encode())
    digest = h.hexdigest()
    if lib_path.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return ""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        run = host_command(tmp_lib)
        try:
            proc = subprocess.run(run, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the host core's compiler did not run: {' '.join(run)}\n{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"the host core's compiler failed ({proc.returncode}):\n"
                               f"{' '.join(run)}\n{proc.stdout}{proc.stderr}")
        (Path(tmp) / stamp.name).write_text(digest)
        os.replace(tmp_lib, lib_path)
        os.replace(Path(tmp) / stamp.name, stamp)
    return " ".join(cmd)


def sources_hash() -> str:
    """A hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*_sources(), *CSRC_DIR.glob("*.cuh")]):
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
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tmp}/{src.stem}.o", str(src)]
            if ptxas_verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        log = ""
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                for _, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        # link to a private name, then rename: a concurrent loader never sees
        # a half-written library
        lib_tmp = f"{tmp}/{LIB_PATH.name}"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp,
               *(f"{tmp}/{src.stem}.o" for src in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(lib_tmp, LIB_PATH)
    STAMP_PATH.write_text(digest)
    return log + proc.stdout + proc.stderr


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
