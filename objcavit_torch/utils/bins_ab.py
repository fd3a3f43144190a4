"""Kernels 2 and 3 against an earlier build of their source, in turns on one card.

    python -m objcavit_torch.utils.bins_ab --old OLD.cu [--alt ALT.cu ...] [--rounds 8]

``OLD.cu`` is an earlier ``csrc/bins_depth.cu`` with the first port's C
interface (``git show 43c3e27:objcavit_torch/csrc/bins_depth.cu``), whose
tenth argument is the pixels a block takes (``old_pix_per_block`` computes
it as its wrapper did); the current source takes the most blocks to launch
there. Each ``ALT.cu`` is a variant of the current source, with its C
interface, timed beside them (a variant's errors are printed, not
enforced). Each source is compiled alone into ``objcavit_torch/_build/ab/``.

At the flagship's shape, (8, 240, 320, 128) with random weights from seed
0: kernel 2 (one W an image) and kernel 3 (one W for the batch, the same
kernel with a weight stride of 0), and kernel 2 again with the bias shifted
by ``EXACT_SHIFT``, so that every unit takes the exact fold (its products
run three times; ``kernel_io.exact_fold_units`` counts them). Each source is first held against the
plain version at chip_smoke.py's tolerance (rtol and atol 1e-5), and the
current one must give the same bits on two calls. Then all sources are
timed as CUDA-graph replays of ``CALLS`` calls, in turns, the order
reversed every round; the median and spread of the rounds are printed.
Prints the card's name and power limit, then one JSON line per kernel with
the bound (bytes once over 3.35 TB/s, or the products over 989 TFLOP/s),
the exps' count and their time on the SFU beside it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import build
from objcavit_torch.utils.detect_head_ab import CALLS, captured, replay_ms
from objcavit_torch.utils.kernel_io import exact_fold_units

SHAPE = (8, 240, 320, 128)  # the flagship's decoder features at half resolution
RTOL, ATOL = 1e-5, 1e-5  # chip_smoke.py's BINS_RTOL, BINS_ATOL
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # NVIDIA H100 SXM data sheet
PEAK_BF16_PER_MS = 989e12 / 1e3
EX2_PER_CLOCK_SM = 16  # the SFU's fp32 ex2 rate on Hopper
EXACT_SHIFT = 40.0  # logits near 40: every row's sum of e is past 2^40


def bins_cost(b: int, s: int, c: int, shared_w: bool) -> dict:
    """Bytes once (x, W, bias and centres read, fp32 depth written), the
    bf16 products and the exps of one call, and the bound: the larger of
    the bytes over the memory rate and the products over the bf16 peak."""
    nbytes = 2 * b * s * c + 2 * (1 if shared_w else b) * c * 256 + 4 * 256 + 4 * b * 256 \
        + 4 * b * s
    flops = 2 * b * s * c * 256
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, flops / PEAK_BF16_PER_MS
    return {"bytes": nbytes, "flops": flops, "exps": b * s * 256,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def sfu_ms(exps: int, n_sm: int, sm_mhz: float) -> float:
    """The exps' time on the SFU alone: 16 ex2 a clock an SM at ``sm_mhz``."""
    return exps / (EX2_PER_CLOCK_SM * n_sm * sm_mhz * 1e3)


def max_sm_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0])


def load_entry(source: Path, name: str, argtypes=build.SIGNATURES[
        "objcavit_conv_bins_depth_batched"]):
    """Compile ``source`` alone and bind its ``objcavit_conv_bins_depth_batched``."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libbins_{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).objcavit_conv_bins_depth_batched
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def old_pix_per_block(b: int, s: int, n_sm: int) -> int:
    """The first port's wrapper: about two blocks an SM over the batch, each
    a multiple of 128 pixels of one image."""
    per_image = max(1, -(-2 * n_sm // b))
    pix = -(-s // per_image)
    return -(-pix // 128) * 128


def call(fn, x, wts, bias, centers, *last_args: int) -> torch.Tensor:
    """A build's entry point on the wrapper's arguments; ``last_args`` are
    the grid and the ring plan (current interface) or the pixels a block
    (the first port's)."""
    b, h, w, c = x.shape
    depth = torch.empty((b, h, w, 1), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), wts.data_ptr(), bias.data_ptr(), centers.data_ptr(), depth.data_ptr(),
            b, h * w, c, wts.stride(0), *last_args, torch.cuda.current_stream().cuda_stream)
    build.check_launch("objcavit_conv_bins_depth_batched", rc)
    return depth


def bad_count(got: torch.Tensor, want: torch.Tensor) -> int:
    err = (got - want).abs()
    return int((~(err <= ATOL + RTOL * want.abs())).sum())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", type=Path, required=True, help="an earlier bins_depth.cu")
    parser.add_argument("--alt", type=Path, action="append", default=[],
                        help="a variant of the current bins_depth.cu (repeatable)")
    parser.add_argument("--rounds", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bins_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    # the first port's entry: no ring plan
    old_sig = build.SIGNATURES["objcavit_conv_bins_depth_batched"][:-3] + (ctypes.c_void_p,)
    old = load_entry(args.old, "old", old_sig)
    alts = {f"alt{n}": load_entry(path, f"alt{n}") for n, path in enumerate(args.alt)}
    for name, path in zip(alts, args.alt):
        print(f"{name}: {path}", flush=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, w, c = SHAPE
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    per_image = (0.1 * torch.randn((b, c, 256), generator=gen, device="cuda")).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=gen, device="cuda")
    centers = torch.sort(0.001 + 10 * torch.rand((b, 256), generator=gen, device="cuda"),
                         dim=1).values
    ppb = old_pix_per_block(b, h * w, n_sm)
    with torch.no_grad():
        for kernel, wts, shift in ((2, per_image, 0.0), (3, per_image[0].expand(b, c, 256), 0.0),
                                   (2, per_image, EXACT_SHIFT)):
            bias_s = bias + shift
            wrapper = (lambda: kbins.conv_bins_depth_batched(x, wts, bias_s, centers)) \
                if kernel == 2 else (lambda: kbins.conv_bins_depth(x, wts[0], bias_s, centers))
            plan = kbins.ring_plan(c)
            calls = {"new": wrapper, "old": lambda: call(old, x, wts, bias_s, centers, ppb),
                     **{name: (lambda fn=fn: call(fn, x, wts, bias_s, centers, n_sm, *plan))
                        for name, fn in alts.items()}}
            want = kbins.conv_bins_depth_batched_plain(x, wts, bias_s, centers)
            first = calls["new"]()
            bad = {name: bad_count(fn(), want) for name, fn in calls.items()}
            deterministic = torch.equal(first, calls["new"]())
            if bad["new"] or bad["old"] or not deterministic:
                raise AssertionError(f"kernel {kernel}: out of tolerance {bad}, two calls "
                                     f"{'equal' if deterministic else 'differ'}")
            graphs = {name: captured(fn) for name, fn in calls.items()}
            times = {name: [] for name in calls}
            for r in range(args.rounds):
                for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                    times[name].append(replay_ms(graphs[name]))
            del graphs
            cost = bins_cost(b, h * w, c, kernel == 3)
            exact, units = exact_fold_units(x, wts, bias_s)
            row = {"kernel": kernel, "shape": list(SHAPE), "bias_shift": shift,
                   "exact_fold_units": [exact, units], "bad": bad,
                   "bitwise_repeatable": deterministic, "calls_per_graph": CALLS,
                   "rounds": args.rounds,
                   **{f"{n}_ms": statistics.median(t) for n, t in times.items()},
                   **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()},
                   **cost, "sfu_ms": sfu_ms(cost["exps"], n_sm, mhz), "max_sm_mhz": mhz,
                   "card": smi}
            print("bins_ab", json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
