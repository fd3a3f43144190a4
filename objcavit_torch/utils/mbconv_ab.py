"""Kernel 8 against an earlier build of it and its variants, in turns on one card.

    python -m objcavit_torch.utils.mbconv_ab --old OLD.cu [--alt ALT.cu ...] [--split] [--rounds 8]

``OLD.cu`` is an earlier ``csrc/mbconv_head.cu`` with the same C interface
(``git show 7de7e3b:objcavit_torch/csrc/mbconv_head.cu``, PR 5's kernel:
``objcavit_mbconv_head(x, we, be, wd, bd, y, partial, pool, nb, h, w, cin, m,
ksize, xsb, xsh, xsw, ysb, ysh, ysw, expand, with_pool, stream)``). Each
``ALT.cu`` is a variant, with that interface, timed beside them; a variant's
errors are printed, not enforced, so a variant may leave a phase out.
``--split`` adds three variants of ``OLD.cu`` made by cutting its phases out
of the source (``SPLIT_PHASES``): the loads alone, the loads and the expand
(no depthwise), the loads and the depthwise (no expand); and three builds of
the current source with ``OBJCAVIT_MBCONV_SKIP`` (``NEW_SPLITS``): the loads
and the expand's products (no SiLU epilogue, no depthwise), the loads and
the expand (no depthwise), the loads, the products and the depthwise (no
epilogue). Each source is compiled alone into ``objcavit_torch/_build/ab/``.

At each of B5's eight stride-1 MBConv shapes at 480x640, batch 8
(``MBCONV_SHAPES``), the current kernel (through ``mbconv_expand_dw_pool``)
and the old one are held against the plain version
(``kernel_io.mbconv_head_errors`` at chip_smoke.py's tolerances), then every
source is timed as CUDA-graph replays of ``CALLS`` calls, in turns, the
order reversed every round. Prints the card's name and power limit, then
one JSON line per shape (the median and spread of each source in ms a call,
the bound, the shape's launches in a forward, the current kernel's plan and
work items), then the sum over the forward's 32 launches.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
from pathlib import Path

import torch

from objcavit_torch.kernels import build
from objcavit_torch.kernels import mbconv as kmb
from objcavit_torch.utils.detect_head_ab import CALLS, captured, replay_ms
from objcavit_torch.utils.kernel_io import mbconv_head_errors

BATCH = 8
# B5's stride-1 MBConv blocks at 480x640: (H, W, k, Cin, M, blocks of that
# shape in a forward); 32 blocks
MBCONV_SHAPES = [(120, 160, 3, 40, 240, 4), (60, 80, 5, 64, 384, 4), (30, 40, 3, 128, 768, 6),
                 (30, 40, 5, 128, 768, 1), (30, 40, 5, 176, 1056, 6), (15, 20, 5, 304, 1824, 8),
                 (15, 20, 3, 304, 1824, 1), (15, 20, 3, 512, 3072, 2)]
MB_RTOL, MB_ATOL, POOL_RTOL = 2.0 ** -7, 1e-5, 1e-4  # chip_smoke.py's
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/ms, and dense
# operations/ms on the tensor cores in bf16 and on the CUDA cores in fp32
HBM_BYTES_PER_MS = 3.35e12 / 1e3
PEAK_OPS_PER_MS = {"bf16": 989e12 / 1e3, "fp32": 67e12 / 1e3}
PR5_TILE = (8, 16)  # PR 5's output tile: its pool partials are one per tile
# PR 5's source, its phases as (first line, line after the last) of the
# region that ``--split`` cuts out: the expand's products, the expand's
# epilogue, the depthwise
SPLIT_PHASES = {
    "mma": ("#pragma unroll\n      for (int kk = 0; kk < kKC; kk += 16) {",
            "      __syncthreads();  // every warp is done with this stage"),
    "epilogue": ("    // accumulator (t, nt, j): band pixel",
                 "  } else {\n    // no expand"),
    "depthwise": ("#pragma unroll 1\n  for (int job = tid; job < kJobs; job += kThreads) {",
                  "  if (with_pool) {\n    __syncthreads();"),
}
SPLITS = {"loads": ("mma", "epilogue", "depthwise"), "loads_expand": ("depthwise",),
          "loads_dw": ("mma", "epilogue")}
# the current source's phases a build leaves out (csrc/mbconv_head.cu's
# OBJCAVIT_MBCONV_SKIP: 1 the expand's epilogue, 2 the depthwise)
NEW_SPLITS = {"loads_products": 3, "loads_expand": 2, "loads_products_dw": 1}


def mbconv_bound(n: int, cin: int, m: int, k: int, expand: bool, with_pool: bool,
                 batch: int = BATCH) -> dict:
    """The least time the card could take for one call on n = B H W pixels:
    x read and y written once (bf16), the weights and biases read once, the
    pool written once, over the memory rate; the expand's 2 n Cin M products
    on the tensor cores and the depthwise's 2 k^2 n M on the CUDA cores, each
    over its unit's peak. The units run at once, so the larger of the two
    operation times, not their sum."""
    nbytes = 2 * n * (cin + m) + 2 * k * k * m + 4 * m + 4 * batch * m * with_pool
    if expand:
        nbytes += 2 * cin * m + 4 * m
    by_bytes = nbytes / HBM_BYTES_PER_MS
    by_ops = max(2 * n * cin * m * expand / PEAK_OPS_PER_MS["bf16"],
                 2 * k * k * n * m / PEAK_OPS_PER_MS["fp32"])
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def split_source(text: str, phases: tuple[str, ...]) -> str:
    """PR 5's source with the regions of ``phases`` cut out."""
    for phase in phases:
        first, after = SPLIT_PHASES[phase]
        start = text.find(first)
        end = text.find(after, start)
        if start < 0 or end < 0:
            raise ValueError(f"--split: the old source has no {phase} region as PR 5's has")
        text = text[:start] + text[end:]
    return text


# PR 5's C interface: the current one less the plan
OLD_SIGNATURE = build.SIGNATURES["objcavit_mbconv_head"][:22] + (ctypes.c_void_p,)


def load_entry(source: Path, name: str, argtypes: tuple, defines: tuple = ()):
    """Compile ``source`` alone (with ``-D`` ``defines``) and bind its
    ``objcavit_mbconv_head``."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libmbconv_{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared", "-o",
           str(lib_path), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).objcavit_mbconv_head
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def scratch_floats(b: int, h: int, w: int, cin: int, m: int, k: int) -> int:
    """Pool-partial scratch, in floats, that both PR 5's kernel and the
    current plan take."""
    pr5 = -(-h // PR5_TILE[0]) * -(-w // PR5_TILE[1])
    return max(pr5, kmb.mbconv_plan(h, w, cin, m, k).partials) * b * m


def other_head(fn, x, we, be, wd, bd, k, partial, old: bool):
    """An earlier (``old``: PR 5's interface) or variant kernel 8, called as
    the wrapper calls it."""
    b, h, w, cin = x.shape
    m = we.shape[1]
    y = torch.empty((b, h, w, m), dtype=x.dtype, device=x.device)
    pool = torch.empty((b, m), dtype=torch.float32, device=x.device)
    plan = kmb.mbconv_plan(h, w, cin, m, k)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    knobs = () if old else (plan.strip_w, plan.group_rows, plan.seg_groups, plan.grid(b, sms),
                            plan.stages, plan.smem)
    rc = fn(x.data_ptr(), we.data_ptr(), be.data_ptr(), wd.data_ptr(), bd.data_ptr(), y.data_ptr(),
            partial.data_ptr(), pool.data_ptr(), b, h, w, cin, m, k, h * w * cin, w * cin, cin,
            h * w * m, w * m, m, 1, 1, *knobs, torch.cuda.current_stream().cuda_stream)
    build.check_launch("other objcavit_mbconv_head", rc)
    return y, pool


def mbconv_inputs(gen, b: int, h: int, w: int, cin: int, m: int, k: int):
    """chip_smoke.py's inputs: bf16 x ~ N(0, 1), we ~ N(0, 1/Cin), wd ~ N(0,
    0.09), fp32 be ~ N(0, 1) and bd ~ N(0, 0.09)."""
    x = torch.randn((b, h, w, cin), generator=gen, device="cuda").to(torch.bfloat16)
    we = (torch.randn((cin, m), generator=gen, device="cuda") / cin ** 0.5).to(torch.bfloat16)
    be = torch.randn(m, generator=gen, device="cuda")
    wd = (0.3 * torch.randn((k, k, 1, m), generator=gen, device="cuda")).to(torch.bfloat16)
    bd = 0.3 * torch.randn(m, generator=gen, device="cuda")
    return x, we, be, wd, bd


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", type=Path, required=True, help="an earlier mbconv_head.cu")
    parser.add_argument("--alt", type=Path, action="append", default=[],
                        help="a variant with the same C interface (repeatable)")
    parser.add_argument("--split", action="store_true",
                        help="also time OLD (PR 5's source) and the current source with "
                             "their phases left out")
    parser.add_argument("--rounds", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mbconv_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sources = {"old": args.old, **{f"alt{n}": path for n, path in enumerate(args.alt)}}
    if args.split:
        text = args.old.read_text()
        out_dir = build.BUILD_DIR / "ab"
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, phases in SPLITS.items():
            path = out_dir / f"old_{name}.cu"
            path.write_text(split_source(text, phases))
            sources[f"old_{name}"] = path
    fns = {name: load_entry(path, name, build.SIGNATURES["objcavit_mbconv_head"]
                            if name.startswith("alt") else OLD_SIGNATURE)
           for name, path in sources.items()}
    if args.split:
        current = build.CSRC_DIR / "mbconv_head.cu"
        for name, skip in NEW_SPLITS.items():
            fns[f"new_{name}"] = load_entry(current, f"new_{name}",
                                            build.SIGNATURES["objcavit_mbconv_head"],
                                            (f"OBJCAVIT_MBCONV_SKIP={skip}",))
    for name, path in sources.items():
        print(f"{name}: {path}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {}
    for h, w, k, cin, m, blocks in MBCONV_SHAPES:
        args_in = mbconv_inputs(gen, BATCH, h, w, cin, m, k)
        partial = torch.empty(scratch_floats(BATCH, h, w, cin, m, k), dtype=torch.float32,
                              device="cuda")
        calls = {"new": lambda: kmb.mbconv_expand_dw_pool(*args_in, k),
                 **{name: (lambda fn=fn, old=name.startswith("old"):
                           other_head(fn, *args_in, k, partial, old))
                    for name, fn in fns.items()}}
        errs = {name: mbconv_head_errors(*args_in, k, *call(), MB_RTOL, MB_ATOL, POOL_RTOL)
                for name, call in calls.items()}
        graphs = {name: captured(fn) for name, fn in calls.items()}
        times = {name: [] for name in calls}
        for r in range(args.rounds):
            order = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for name in order:
                times[name].append(replay_ms(graphs[name]))
        del graphs
        plan = kmb.mbconv_plan(h, w, cin, m, k)
        row = {"shape": [BATCH, h, w, k, cin, m], "blocks_a_forward": blocks,
               "plan": dataclasses.asdict(plan),
               "work_items": plan.work_items(BATCH), "errors": errs,
               "calls_per_graph": CALLS, "rounds": args.rounds,
               **{f"{n}_ms": statistics.median(t) for n, t in times.items()},
               **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()},
               **mbconv_bound(BATCH * h * w, cin, m, k, expand=True, with_pool=True),
               "card": smi}
        print("mbconv_ab shape", json.dumps(row), flush=True)
        for key in [f"{n}_ms" for n in times] + ["bound_ms"]:
            sums[key] = sums.get(key, 0.0) + blocks * row[key]
        if errs["new"]["bad"] or errs["old"]["bad"]:
            raise AssertionError(f"{(h, w, k, cin, m)}: values out of tolerance {errs}")
        del args_in, partial
    print("mbconv_ab forward", json.dumps({"launches": sum(s[-1] for s in MBCONV_SHAPES),
                                           **sums, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
