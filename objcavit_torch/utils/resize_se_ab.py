"""Kernels 1 and 7 against their earlier builds, in turns on one card.

    python -m objcavit_torch.utils.resize_se_ab [--old-resize OLD.cu] [--old-se OLD.cu] [--rounds 8]

``--old-resize`` is an earlier ``csrc/resize_bilinear.cu`` with the first
port's C interface (``git show 5f1b64f:objcavit_torch/csrc/resize_bilinear.cu``:
``objcavit_resize_bilinear_ac_nhwc_bf16(x, y, h_lo, h_hi, h_frac, w_lo, w_hi,
w_frac, b, hi, wi, c, ho, wo, stream)``); ``--old-se`` an earlier
``csrc/se_project.cu`` with that of the fused-MBConv slice (``git show
7de7e3b:objcavit_torch/csrc/se_project.cu``: ``objcavit_se_project(x, gate, w,
bias, skip, out, rows, hw, m, o, stream)``). Each is compiled alone into
``objcavit_torch/_build/ab/``. Without one, its kernel's section is skipped.

Kernel 1, at the flagship's four decoder upsamples at 480x640, batch 8
(``RESIZE_SHAPES``): the old kernel, the current one (bare), the current
one's concat form (upsample and skip into one buffer, as the decoder runs
it), the old kernel + ``torch.cat`` (the route the concat form replaced) and
``F.interpolate``, beside the bounds of the bare and the concat contracts
(bytes once over 3.35 TB/s). Kernel 7, at its seven shapes
(``SE_SHAPES``): the old kernel, the current one and ``torch.baddbmm`` on
the gate folded into W per image (timed only: it rounds elsewhere), beside
the bound. Each kernel is first held against its plain version at
chip_smoke.py's tolerances (the skip slice bit for bit). Then all sources of
a shape are timed as CUDA-graph replays of ``CALLS`` calls, in turns, the
order reversed every round; the median and spread of the rounds are
printed. Prints the card's name and power limit, one JSON line per shape,
then each kernel's sums over a forward's launches.
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
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.kernels import se_project as kse
from objcavit_torch.ops.resize import device_taps
from objcavit_torch.utils.detect_head_ab import CALLS, captured, replay_ms
from objcavit_torch.utils.kernel_io import se_project_errors

BATCH = 8
# the flagship's decoder upsamples at 480x640: (Hi, Wi, C) -> (Ho, Wo), and
# the channels Cs of the skip each is concatenated with
RESIZE_SHAPES = [(17, 22, 2048, 30, 40, 176), (30, 40, 1024, 60, 80, 64),
                 (60, 80, 512, 120, 160, 40), (120, 160, 256, 240, 320, 24)]
# kernel 7 on its route: (H, W, M, O, skip, launches in a forward): the
# DepthwiseSeparable blocks at 240x320, the four stride-2 first blocks, and
# stage 6's 3072 -> 512 (kernel 8's route there: no launch; reached with
# se_project alone)
SE_SHAPES = [(240, 320, 48, 24, False, 1), (240, 320, 24, 24, True, 2),
             (120, 160, 144, 40, False, 1), (60, 80, 240, 64, False, 1),
             (30, 40, 384, 128, False, 1), (15, 20, 1056, 304, False, 1),
             (15, 20, 3072, 512, True, 0)]
RESIZE_RTOL, RESIZE_ATOL = 2.0 ** -7, 1e-5  # chip_smoke.py's
MB_RTOL, MB_ATOL = 2.0 ** -7, 1e-5  # chip_smoke.py's, kernel 7
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # NVIDIA H100 SXM data sheet
PEAK_BF16_PER_MS = 989e12 / 1e3
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_RESIZE = ("objcavit_resize_bilinear_ac_nhwc_bf16", (_P,) * 8 + (_I,) * 6 + (_P,))
OLD_SE = ("objcavit_se_project", (_P,) * 6 + (_I,) * 4 + (_P,))


def load_old(source: Path, tag: str, entry: tuple[str, tuple]):
    """Compile ``source`` alone and bind its entry point ``entry`` (name,
    argtypes)."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{tag}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib_path)), entry[0])
    fn.argtypes = entry[1]
    fn.restype = ctypes.c_int
    return fn


def old_resize(fn, x: torch.Tensor, ho: int, wo: int) -> torch.Tensor:
    b, hi, wi, c = x.shape
    taps = (*device_taps(hi, ho, True, x.device), *device_taps(wi, wo, True, x.device))
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in taps), b, hi, wi, c, ho, wo,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("old objcavit_resize_bilinear_ac_nhwc_bf16", rc)
    return y


def old_se(fn, dw, gate, kern, bias, skip) -> torch.Tensor:
    b, h, w, m = dw.shape
    o = kern.shape[1]
    out = torch.empty((b, h, w, o), dtype=dw.dtype, device=dw.device)
    rc = fn(dw.data_ptr(), gate.data_ptr(), kern.data_ptr(), bias.data_ptr(),
            None if skip is None else skip.data_ptr(), out.data_ptr(), b * h * w, h * w, m, o,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("old objcavit_se_project", rc)
    return out


def resize_bounds(hi: int, wi: int, c: int, ho: int, wo: int, cs: int) -> dict:
    """Bytes once over the memory rate: the bare contract (x read, the
    upsample written) and the concat form (x and the skip read, C + Cs
    channels written)."""
    bare = 2 * BATCH * c * (hi * wi + ho * wo)
    concat = 2 * BATCH * (c * hi * wi + cs * ho * wo + (c + cs) * ho * wo)
    return {"bound_ms": bare / HBM_BYTES_PER_MS, "concat_bound_ms": concat / HBM_BYTES_PER_MS}


def se_bound(h: int, w: int, m: int, o: int, with_skip: bool) -> float:
    """The larger of bytes once (x, gate, W, bias and skip read, out written)
    over the memory rate and the 2 n M O products over the bf16 peak."""
    n = BATCH * h * w
    nbytes = 2 * n * m + 2 * BATCH * m + 2 * m * o + 4 * o + 2 * n * o * (1 + with_skip)
    return max(nbytes / HBM_BYTES_PER_MS, 2 * n * m * o / PEAK_BF16_PER_MS)


def timed(calls: dict, rounds: int) -> dict:
    """Median and spread of each call's ms, CUDA-graph replays in turns."""
    graphs = {name: captured(fn) for name, fn in calls.items()}
    times = {name: [] for name in calls}
    for r in range(rounds):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            times[name].append(replay_ms(graphs[name]))
    del graphs
    return {**{f"{n}_ms": statistics.median(t) for n, t in times.items()},
            **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()}}


def close_bad(got: torch.Tensor, want: torch.Tensor) -> int:
    err = (got.float() - want.float()).abs()
    return int((err > RESIZE_ATOL + RESIZE_RTOL * want.float().abs()).sum())


def run_resize(fn, rounds: int, smi: str, gen) -> None:
    sums: dict[str, float] = {}
    for hi, wi, c, ho, wo, cs in RESIZE_SHAPES:
        x = torch.randn((BATCH, hi, wi, c), generator=gen, device="cuda").to(torch.bfloat16)
        skip = torch.randn((BATCH, ho, wo, cs), generator=gen, device="cuda").to(torch.bfloat16)
        want = kresize.resize_bilinear_align_corners_plain(x, ho, wo)
        concat = kresize.resize_bilinear_align_corners_into_concat(x, skip)
        bad = {"old": close_bad(old_resize(fn, x, ho, wo), want),
               "new": close_bad(kresize.resize_bilinear_align_corners(x, ho, wo), want),
               "concat": close_bad(concat[..., :c], want)
               + int((concat[..., c:].view(torch.int16) != skip.view(torch.int16)).sum())}
        x_nchw = x.permute(0, 3, 1, 2)
        calls = {"old": lambda: old_resize(fn, x, ho, wo),
                 "new": lambda: kresize.resize_bilinear_align_corners(x, ho, wo),
                 "concat": lambda: kresize.resize_bilinear_align_corners_into_concat(x, skip),
                 "old_cat": lambda: torch.cat([old_resize(fn, x, ho, wo), skip], -1),
                 "interpolate": lambda: F.interpolate(x_nchw, size=(ho, wo), mode="bilinear",
                                                      align_corners=True)}
        row = {"kernel": 1, "shape": [BATCH, hi, wi, c, ho, wo, cs], "bad": bad,
               "plan": vars(kresize.resize_plan(hi, wi, c, ho, wo)), "calls_per_graph": CALLS,
               "rounds": rounds, **timed(calls, rounds), **resize_bounds(hi, wi, c, ho, wo, cs),
               "card": smi}
        print("resize_se_ab shape", json.dumps(row), flush=True)
        for key in [f"{n}_ms" for n in calls] + ["bound_ms", "concat_bound_ms"]:
            sums[key] = sums.get(key, 0.0) + row[key]
        if any(bad.values()):
            raise AssertionError(f"kernel 1 {(hi, wi, c, ho, wo)}: values out of tolerance {bad}")
        del x, skip, want, concat
    print("resize_se_ab kernel 1 forward", json.dumps({"launches": len(RESIZE_SHAPES), **sums,
                                                      "card": smi}), flush=True)


def run_se(fn, rounds: int, smi: str, gen) -> None:
    sums: dict[str, float] = {}
    for h, w, m, o, with_skip, launches in SE_SHAPES:
        dw = torch.randn((BATCH, h, w, m), generator=gen, device="cuda").to(torch.bfloat16)
        gate = torch.rand((BATCH, m), generator=gen, device="cuda").to(torch.bfloat16)
        kern = (torch.randn((m, o), generator=gen, device="cuda") / m ** 0.5).to(torch.bfloat16)
        bias = 0.1 * torch.randn(o, generator=gen, device="cuda")
        skip = (torch.randn((BATCH, h, w, o), generator=gen, device="cuda").to(torch.bfloat16)
                if with_skip else None)
        args = (dw, gate, kern, bias, skip)
        new = kse.se_gate_project(*args)
        bad = {"old": se_project_errors(*args, old_se(fn, *args), MB_RTOL, MB_ATOL)["bad"],
               "new": se_project_errors(*args, new, MB_RTOL, MB_ATOL)["bad"]}
        # the yardstick: one cuBLAS call on operands made beforehand
        lib_in = (bias.to(torch.bfloat16) + skip.reshape(BATCH, h * w, o) if with_skip
                  else bias.to(torch.bfloat16))
        lib_w, lib_a = gate[:, :, None] * kern, dw.reshape(BATCH, h * w, m)
        calls = {"old": lambda: old_se(fn, *args), "new": lambda: kse.se_gate_project(*args),
                 "baddbmm": lambda: torch.baddbmm(lib_in, lib_a, lib_w)}
        row = {"kernel": 7, "shape": [BATCH, h, w, m, o, with_skip], "launches": launches,
               "bad": bad, "plan": vars(kse.se_plan(BATCH * h * w, h * w, m, o, BATCH, with_skip)),
               "calls_per_graph": CALLS, "rounds": rounds, **timed(calls, rounds),
               "bound_ms": se_bound(h, w, m, o, with_skip), "card": smi}
        print("resize_se_ab shape", json.dumps(row), flush=True)
        for key in [f"{n}_ms" for n in calls] + ["bound_ms"]:
            sums[key] = sums.get(key, 0.0) + launches * row[key]
        if any(bad.values()):
            raise AssertionError(f"kernel 7 {(h, w, m, o)}: values out of tolerance {bad}")
        del dw, gate, kern, bias, skip, new, lib_in, lib_w, lib_a
    print("resize_se_ab kernel 7 forward", json.dumps(
        {"launches": sum(s[-1] for s in SE_SHAPES), **sums, "card": smi}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-resize", type=Path, help="an earlier resize_bilinear.cu")
    parser.add_argument("--old-se", type=Path, help="an earlier se_project.cu")
    parser.add_argument("--rounds", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resize_se_ab: needs a CUDA card")
    if args.old_resize is None and args.old_se is None:
        raise SystemExit("resize_se_ab: give --old-resize, --old-se or both")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        if args.old_resize is not None:
            run_resize(load_old(args.old_resize, "resize_old", OLD_RESIZE), args.rounds, smi, gen)
        if args.old_se is not None:
            run_se(load_old(args.old_se, "se_old", OLD_SE), args.rounds, smi, gen)


if __name__ == "__main__":
    main()
