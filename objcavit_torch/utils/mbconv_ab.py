"""Kernels 8 and 10 against earlier builds of them and their variants, in turns on one card.

    python -m objcavit_torch.utils.mbconv_ab --old OLD.cu [--alt ALT.cu ...] [--split] [--rounds 8]
    python -m objcavit_torch.utils.mbconv_ab --dw --old OLD.cu [--alt ALT.cu ...] [--split]
        [--plans JSON] [--rounds 8]

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

``--dw`` times kernel 10 (``csrc/dw_silu_pool.cu``, through
``dw_conv_silu_pool``) instead, at ``DW_CASES`` and the card tests' edge
shapes (``DW_EDGE_CASES``), against ``OLD.cu``, an earlier
``csrc/mbconv_head.cu`` whose entry still ran kernel 10 with ``expand`` 0
(``git show bd81be6:objcavit_torch/csrc/mbconv_head.cu``: the first
port's tiled kernel, the interface before the expand argument went), and
beside them cuDNN's depthwise conv with its bias alone (one
``F.conv2d(..., groups=C)`` on channels-last bf16: a part of the function,
for context; no one PyTorch call computes the whole). Each ``ALT.cu`` is a variant of
``dw_silu_pool.cu`` with its C interface; ``--split`` adds builds of the
current source with ``OBJCAVIT_DW_SKIP=1`` (the loads alone) and ``=2``
(the taps and stores alone); ``--plans`` is a JSON list of edits of ``dw_plan``'s plan
(e.g. ``[{"seg_rows": 15}, {"strip_w": 40}]``), each timed as a variant of
the current kernel where it fits the case. Prints the card's name and power
limit, one JSON line per case (each source's median and spread in ms a call,
errors, the bound, the plan) and the sums over ``DW_CASES``.
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
import torch.nn.functional as F

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
# kernel 10's cases at B5's widths (H, W, k, C, with the pool), batch 8:
# stage 1's depthwise with and without the pool, stage 2's at k 5, stage
# 5's 1824 channels
DW_CASES = [(120, 160, 3, 240, True), (120, 160, 3, 240, False), (60, 80, 5, 384, True),
            (15, 20, 5, 1824, False)]
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


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the first port's C interface: pointers, sizes, strides, expand, with_pool, stream
OLD_SIGNATURE = (_P,) * 8 + (_I,) * 6 + (_LL,) * 6 + (_I, _I, _P)
# the interface before kernel 10 left mbconv_head.cu: the current one with
# expand before with_pool
EXPAND_SIGNATURE = OLD_SIGNATURE[:-1] + (_I,) * 5 + (_LL, _P)
# kernel 10's edge shapes of tests/test_torch_gpu.py: (B, H, W, C, k, with the pool)
DW_EDGE_CASES = [(2, 9, 21, 240, 3, True), (8, 15, 20, 1824, 5, True), (2, 7, 300, 64, 3, True),
                 (2, 6, 130, 72, 5, True), (2, 1, 37, 64, 5, True), (2, 2, 30, 64, 5, True),
                 (1, 3, 2, 56, 3, True)]


def load_entry(source: Path, name: str, argtypes: tuple, defines: tuple = (),
               symbol: str = "objcavit_mbconv_head"):
    """Compile ``source`` alone (with ``-D`` ``defines``, and ``csrc/`` on
    the include path for its shared header) and bind its ``symbol``."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libmbconv_{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
           f"-I{build.CSRC_DIR}", "-shared", "-o", str(lib_path), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib_path)), symbol)
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
            h * w * m, w * m, m, *((1, 1) if old else (1,)), *knobs,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("other objcavit_mbconv_head", rc)
    return y, pool


def old_dw(fn, x, wd, bd, k, with_pool: bool):
    """Kernel 10 through an earlier ``mbconv_head.cu`` (``EXPAND_SIGNATURE``),
    with ``expand`` 0, as its wrapper called it: pool partials one an 8 x 16
    tile."""
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    partial = pool = None
    if with_pool:
        partial = torch.empty((-(-h // PR5_TILE[0]) * -(-w // PR5_TILE[1]), b, c),
                              dtype=torch.float32, device=x.device)
        pool = torch.empty((b, c), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(x.data_ptr(), None, None, wd.data_ptr(), bd.data_ptr(), y.data_ptr(), ptr(partial),
            ptr(pool), b, h, w, c, c, k, h * w * c, w * c, c, h * w * c, w * c, c, 0,
            int(with_pool), 0, 0, 0, 0, 0, 0, torch.cuda.current_stream().cuda_stream)
    build.check_launch("old objcavit_mbconv_head (expand 0)", rc)
    return y, pool


def dw_variant(fn, x, wd, bd, k, with_pool: bool, plan):
    """A build of ``dw_silu_pool.cu`` called as the wrapper calls it, on
    ``plan``."""
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    partial = pool = None
    if with_pool:
        scratch = kmb.dw_pool_scratch(plan)
        if scratch is not None:
            partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
        pool = torch.empty((b, c), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(x.data_ptr(), wd.data_ptr(), bd.data_ptr(), y.data_ptr(), ptr(partial), ptr(pool), b,
            h, w, c, k, int(with_pool), plan.strip_w, plan.seg_rows, plan.warps, plan.stages,
            plan.grid, torch.cuda.current_stream().cuda_stream)
    build.check_launch("variant objcavit_dw_silu_pool", rc)
    return y, pool


def edited_plan(plan, edit: dict, n_sm: int):
    """``plan`` with ``edit`` applied (the warps follow the strip; the grid,
    unless given, is as many blocks as fit DW_SM_WARPS warps an SM, at most
    the items), or None where the edit does not fit the case."""
    cols = kmb.DW_COLS[plan.k]
    strip_w = edit.get("strip_w", plan.strip_w)
    warps = strip_w // cols
    if strip_w % cols or not 1 <= warps <= kmb.DW_MAX_WARPS or strip_w - cols >= plan.w \
            or edit.get("seg_rows", plan.seg_rows) > plan.h:
        return None
    new = dataclasses.replace(plan, **{**edit, "warps": warps, "grid": 1})
    grid = edit.get("grid", n_sm * max(1, kmb.DW_SM_WARPS // (warps + 1)))
    new = dataclasses.replace(new, grid=min(grid, new.items))
    return new if new.smem <= kmb.SMEM_LIMIT and 2 <= new.stages <= kmb.DW_MAX_STAGES else None


def cudnn_depthwise(x, wd, bd, k: int):
    """A call of cuDNN's depthwise conv with its bias, no SiLU and no pool,
    on x (B, H, W, C) as a channels-last NCHW bf16 tensor: a part of kernel
    10's function, for context."""
    c = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    weight = wd.reshape(k * k, c).t().reshape(c, 1, k, k).contiguous()
    bias = bd.to(x.dtype)
    return lambda: F.conv2d(xc, weight, bias, padding=k // 2, groups=c)


def dw_inputs(gen, b: int, h: int, w: int, c: int, k: int):
    """chip_smoke.py's kernel-10 inputs: bf16 x ~ N(0, 1), wd ~ N(0, 0.09) as
    (k*k, C), fp32 bd ~ N(0, 0.09)."""
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    wd = (0.3 * torch.randn((k * k, c), generator=gen, device="cuda")).to(torch.bfloat16)
    bd = 0.3 * torch.randn(c, generator=gen, device="cuda")
    return x, wd, bd


def main_dw(args, smi: str) -> None:
    """The ``--dw`` mode (see the module note)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dw_sig = build.SIGNATURES["objcavit_dw_silu_pool"]
    current = build.CSRC_DIR / "dw_silu_pool.cu"
    fns = {"old": load_entry(args.old, "dw_old", EXPAND_SIGNATURE)}
    print(f"old: {args.old}", flush=True)
    for n, path in enumerate(args.alt):
        fns[f"alt{n}"] = load_entry(path, f"dw_alt{n}", dw_sig, symbol="objcavit_dw_silu_pool")
        print(f"alt{n}: {path}", flush=True)
    splits = {"loads_alone": ("OBJCAVIT_DW_SKIP=1",),
              "taps_alone": ("OBJCAVIT_DW_SKIP=2",)} if args.split else {}
    for name, defines in splits.items():
        fns[name] = load_entry(current, f"dw_{name}", dw_sig, defines, "objcavit_dw_silu_pool")
    edits = json.loads(args.plans) if args.plans else []
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(8, h, w, c, k, pool) for h, w, k, c, pool in DW_CASES] + DW_EDGE_CASES
    sums = {}
    for i, (b, h, w, c, k, with_pool) in enumerate(cases):
        x, wd, bd = dw_inputs(gen, b, h, w, c, k)
        plan = kmb.dw_plan(b, h, w, c, k, n_sm)
        calls = {"new": lambda: kmb.dw_conv_silu_pool(x, wd, bd, k, with_pool),
                 "old": lambda: old_dw(fns["old"], x, wd, bd, k, with_pool)}
        for name, fn in fns.items():
            if name != "old":
                calls[name] = lambda fn=fn: dw_variant(fn, x, wd, bd, k, with_pool, plan)
        plans = {}
        for n, edit in enumerate(edits):
            other = edited_plan(plan, edit, n_sm)
            if other is not None:
                plans[f"plan{n}"] = other
                calls[f"plan{n}"] = (lambda other=other:
                                     kmb._launch_dw(x, wd, bd, k, with_pool, other))
        calls["cudnn_dw"] = cudnn_depthwise(x, wd, bd, k)
        errs = {name: mbconv_head_errors(x, None, None, wd, bd, k, *call(), MB_RTOL, MB_ATOL,
                                         POOL_RTOL)
                for name, call in calls.items() if name != "cudnn_dw"}
        graphs = {name: captured(fn) for name, fn in calls.items()}
        times = {name: [] for name in calls}
        for r in range(args.rounds):
            order = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for name in order:
                times[name].append(replay_ms(graphs[name]))
        del graphs
        row = {"case": [b, h, w, c, k, with_pool], "plan": dataclasses.asdict(plan),
               "items": plan.items, "errors": errs, "calls_per_graph": CALLS,
               "rounds": args.rounds,
               **{f"{n}_ms": statistics.median(t) for n, t in times.items()},
               **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()},
               **{f"{n}_plan": dataclasses.asdict(p) for n, p in plans.items()},
               **mbconv_bound(b * h * w, c, c, k, expand=False, with_pool=with_pool, batch=b),
               "card": smi}
        print("mbconv_ab dw case", json.dumps(row), flush=True)
        if i < len(DW_CASES):
            for key in [f"{n}_ms" for n in times] + ["bound_ms"]:
                sums[key] = sums.get(key, 0.0) + row[key]
        if errs["new"]["bad"] or errs["old"]["bad"]:
            raise AssertionError(f"{(b, h, w, c, k, with_pool)}: values out of tolerance {errs}")
        del x, wd, bd
    print("mbconv_ab dw cases", json.dumps({"cases": len(DW_CASES), **sums, "card": smi}),
          flush=True)


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
                             "their phases left out (with --dw: kernel 10's loads alone, its "
                             "taps alone, and its pool added by the last block)")
    parser.add_argument("--dw", action="store_true",
                        help="time kernel 10 (OLD is then an mbconv_head.cu that still ran it "
                             "with expand 0)")
    parser.add_argument("--plans", help="--dw: a JSON list of edits of dw_plan's plan")
    parser.add_argument("--rounds", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mbconv_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.dw:
        main_dw(args, smi)
        return
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
