"""Kernel 6 against an earlier build of it, in turns on one card.

    python -m objcavit_torch.utils.detect_head_ab --old OLD.cu [--alt ALT.cu ...] [--rounds 6]

``OLD.cu`` is an earlier ``csrc/detect_head.cu`` (``git show
<commit>:objcavit_torch/csrc/detect_head.cu``): either one with the current C
interface (the wgmma design, its entry taking the key scratch and the grid),
called as ``fused_detect_head`` calls the current one, or one with the
interface of the ``mma.sync`` version (any commit before the wgmma
redesign): ``objcavit_detect_head(x, wcls, bcls, w5c, b5c, y5, coef,
cls_max, cls_arg, m, cin, nc, ncp, nm, block_rows, stream)``; the source's
text tells which. Each ``ALT.cu`` is a variant of the current source, with its C
interface, timed beside them (a variant's errors are printed, not
enforced, so a variant may leave work out to time the rest). Each source
is compiled alone into ``objcavit_torch/_build/ab/``.

At the fused server's six level shapes (NYU 480x640 and KITTI 352x1216,
batch 8, 1203 classes, 32 coefficients) every kernel is checked against
the plain version (``kernel_io.detect_head_errors``, one bf16 ulp plus the
fp32 accumulation bound) and timed as CUDA-graph replays of ``CALLS`` calls,
in turns (new, old, old, new, ...), with the dense head's GEMM (one
``F.linear``) beside them. Prints one JSON line per level, one per request
sum, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from objcavit_torch.kernels import build
from objcavit_torch.kernels import detect_head as kdetect
from objcavit_torch.utils.kernel_io import detect_head_errors

LEVELS = {"nyu": [(8, 4800, 256), (8, 1200, 512), (8, 300, 1024)],
          "kitti": [(8, 6688, 256), (8, 1672, 512), (8, 418, 1024)]}
NUM_CLASSES, NM = 1203, 32
CALLS = 20
RTOL, ATOL = 2.0 ** -7, 1e-5  # chip_smoke.py's DETECT_RTOL, DETECT_ATOL
PEAK_BF16_PER_MS = 989e12 / 1e3


def load_entry(source: Path, name: str, argtypes: tuple):
    """Compile ``source`` alone and bind its ``objcavit_detect_head``."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libdetect_head_{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).objcavit_detect_head
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def alt_head(fn, flat, packed):
    """A variant of the current kernel, called as ``fused_detect_head`` calls it."""
    b, s, cin = flat.shape
    dev, ncp = flat.device, packed.wcls.shape[1]
    out = (torch.empty((b, s, 3, 5), dtype=flat.dtype, device=dev),
           torch.empty((b, s, 3, packed.nm), dtype=flat.dtype, device=dev),
           torch.empty((b, s, 3), dtype=torch.float32, device=dev),
           torch.empty((b, s, 3), dtype=torch.int32, device=dev))
    keys = torch.empty((b, s, 3), dtype=torch.int64, device=dev)
    rc = fn(flat.data_ptr(), packed.wcls.data_ptr(), packed.bcls.data_ptr(),
            packed.w5c.data_ptr(), packed.b5c.data_ptr(), *(t.data_ptr() for t in out),
            keys.data_ptr(), b * s, cin, packed.num_classes, ncp, packed.nm,
            kdetect.block_rows_for(cin, ncp),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("variant objcavit_detect_head", rc)
    return out


def old_head(fn, flat, packed):
    """The old kernel through its own wrapper's rule for block rows."""
    b, s, cin = flat.shape
    m, dev = b * s, flat.device
    y5 = torch.empty((b, s, 3, 5), dtype=flat.dtype, device=dev)
    coef = torch.empty((b, s, 3, packed.nm), dtype=flat.dtype, device=dev)
    cls_max = torch.empty((b, s, 3), dtype=torch.float32, device=dev)
    cls_arg = torch.empty((b, s, 3), dtype=torch.int32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    block_rows = 128 if -(-m // 128) * 3 >= 2 * n_sm else 64
    rc = fn(flat.data_ptr(), packed.wcls.data_ptr(), packed.bcls.data_ptr(),
            packed.w5c.data_ptr(), packed.b5c.data_ptr(), y5.data_ptr(), coef.data_ptr(),
            cls_max.data_ptr(), cls_arg.data_ptr(), m, cin, packed.num_classes,
            packed.wcls.shape[1], packed.nm, block_rows, torch.cuda.current_stream().cuda_stream)
    build.check_launch("old objcavit_detect_head", rc)
    return y5, coef, cls_max, cls_arg


def captured(fn) -> torch.cuda.CUDAGraph:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    return graph


def replay_ms(graph: torch.cuda.CUDAGraph, iters: int = 3) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / CALLS


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", type=Path, required=True, help="an earlier detect_head.cu")
    parser.add_argument("--alt", type=Path, action="append", default=[],
                        help="a variant of the current detect_head.cu (repeatable)")
    parser.add_argument("--rounds", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("detect_head_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    old_takes_grid = "int block_rows, int grid" in args.old.read_text()
    old = load_entry(args.old, "old", build.SIGNATURES["objcavit_detect_head"] if old_takes_grid
                     else (p,) * 9 + (i,) * 6 + (p,))
    print(f"old: {args.old} ({'the current' if old_takes_grid else 'the mma.sync'} interface)",
          flush=True)
    alts = {f"alt{k}": load_entry(path, f"alt{k}", build.SIGNATURES["objcavit_detect_head"])
            for k, path in enumerate(args.alt)}
    for name, path in zip(alts, args.alt):
        print(f"{name}: {path}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    no = 5 + NUM_CLASSES + NM
    for place, shapes in LEVELS.items():
        sums = {f"{name}_ms": 0.0 for name in ("new", "old", *alts, "gemm", "bound")}
        for b, s, cin in shapes:
            flat = torch.randn((b, s, cin), generator=gen, device="cuda").to(torch.bfloat16)
            w = torch.randn((3 * no, cin), generator=gen, device="cuda") / cin ** 0.5
            bias = 0.1 * torch.randn(3 * no, generator=gen, device="cuda")
            packed = kdetect.pack_detect_head(w, bias, NUM_CLASSES, NM, torch.bfloat16)
            wd, bd = w.to(torch.bfloat16), bias.to(torch.bfloat16)
            calls = {"new": lambda: kdetect.fused_detect_head(flat, packed),
                     "old": (lambda: alt_head(old, flat, packed)) if old_takes_grid
                     else (lambda: old_head(old, flat, packed)),
                     **{name: (lambda fn=fn: alt_head(fn, flat, packed))
                        for name, fn in alts.items()},
                     "gemm": lambda: F.linear(flat, wd, bd)}
            bad = {name: detect_head_errors(flat, packed, calls[name](), RTOL, ATOL)["bad"]
                   for name in calls if name != "gemm"}
            graphs = {name: captured(fn) for name, fn in calls.items()}
            times = {name: [] for name in calls}
            for r in range(args.rounds):
                order = list(calls)
                for name in (order if r % 2 == 0 else order[::-1]):
                    times[name].append(replay_ms(graphs[name]))
            del graphs
            flops = 2 * b * s * cin * 3 * no
            row = {"place": place, "shape": [b, s, cin], "bad": bad,
                   **{f"{n}_ms": statistics.median(t) for n, t in times.items()},
                   **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()},
                   "bound_ms": flops / PEAK_BF16_PER_MS}
            for key in sums:
                sums[key] += row[key]
            row.update({f"{n}_tflops": flops / row[f"{n}_ms"] / 1e9 for n in calls})
            print("detect_head_ab level", json.dumps(row), flush=True)
            if bad["new"] or bad["old"]:
                raise AssertionError(f"{place} {(b, s, cin)}: elements out of tolerance {bad}")
        print("detect_head_ab request", json.dumps({"place": place, **sums}), flush=True)


if __name__ == "__main__":
    main()
