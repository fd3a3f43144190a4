#!/usr/bin/env python3
"""Drive objcavit_torch's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the CUDA kernels from ``objcavit_torch/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (TF32 off), then both timed in turns with CUDA events;
4. slice: the flagship server (GraphBins-B5, bf16, BN folded, 480x640, 300
   object slots, random weights from seed 0) answers requests of 8 uint8
   frames, with detector-style object slots and with the no-detection
   sentinel. Launch counters, zeroed just before, must show 4 resize
   launches and 1 bins launch per forward; depth must be finite and in
   range; each kernel's output in those forwards must match its plain
   version on the very tensors the forward gave it; and ObjCAViT's outputs
   must stay close to an fp32 run of the same weights (plain versions, no
   kernel) on a small input. Then the served rate and peak memory.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import build
from objcavit_torch.kernels import resize as kresize
from objcavit_torch.serving import DepthPipeline, build_flagship_pipeline, image_seq_len
from objcavit_torch.utils.kernel_io import plain_outputs, record_kernel_io

BATCH = 8
EVAL_DIMS = (480, 640)
# decoder upsamples of the flagship at 480x640: (Hi, Wi, C) -> (Ho, Wo)
RESIZE_SHAPES = [
    (17, 22, 2048, 30, 40),
    (30, 40, 1024, 60, 80),
    (60, 80, 512, 120, 160),
    (120, 160, 256, 240, 320),
]
BINS_SHAPE = (BATCH, 240, 320, 128)  # decoder features at half resolution
# kernel vs plain: both lerp in fp32 and round to bf16 once, but the kernel's
# FMAs round differently from the plain version's separate multiply and add,
# so a value next to a bf16 rounding boundary may land one bf16 ulp
# (<= 2^-7 relative) away
RESIZE_RTOL, RESIZE_ATOL = 2.0 ** -7, 1e-5
# both sum the same bf16-exact products in fp32 (128 terms, other order) and
# the kernel's exp is __expf: a few fp32 ulps of the depth
BINS_RTOL, BINS_ATOL = 1e-5, 1e-5
# the served depth must spread over at least this many bins tolerances, or
# the bins check on served tensors could not tell a right depth from a flat one
MIN_SPREAD_IN_TOLERANCES = 10
# bf16 model vs the same weights in fp32, on the card: bf16 keeps 8
# significant bits (2^-9 relative rounding) through ~100 layers. Measured on
# an H100: rel L2 0.0030 on ObjCAViT's image features, 0.0069 on its queries
FEATURE_REL_BOUND = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    max_abs = float(err.max())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements out of tolerance, max abs err {max_abs}")
    return max_abs


def time_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_times(kernel, plain, iters: int = 20, rounds: int = 6) -> tuple[float, float]:
    """Median ms per call of each, timed in turns (plain, kernel, kernel, plain, ...)."""
    kernel(), plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for r in range(rounds):
        pair = [(kernel, tk), (plain, tp)]
        for fn, out in (pair if r % 2 else pair[::-1]):
            out.append(time_ms(fn, iters))
    return statistics.median(tk), statistics.median(tp)


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    out = build.build(ptxas_verbose=True)
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({build.LIB_PATH.name})")
    for line in out.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    resize = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for hi, wi, c, ho, wo in RESIZE_SHAPES:
        x = torch.randn((BATCH, hi, wi, c), generator=g, device=dev).to(torch.bfloat16)
        kernel = lambda: kresize.resize_bilinear_align_corners(x, ho, wo)  # noqa: E731
        plain = lambda: kresize.resize_bilinear_align_corners_plain(x, ho, wo)  # noqa: E731
        err = check_close(f"resize {(hi, wi, c)}->{(ho, wo)}", kernel(), plain(),
                          RESIZE_RTOL, RESIZE_ATOL)
        ms, plain_ms = compare_times(kernel, plain)
        log(f"kernel resize ({BATCH},{hi},{wi},{c})->({ho},{wo}): max_abs_err {err} "
            f"(rtol 2^-7, atol 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        resize["max_abs_err"] = max(resize["max_abs_err"], err)
        resize["ms"] += ms
        resize["plain_ms"] += plain_ms

    b, h, w, c = BINS_SHAPE
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    wts = (0.1 * torch.randn((b, c, 256), generator=g, device=dev)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=g, device=dev)
    centers = torch.sort(0.001 + 10 * torch.rand((b, 256), generator=g, device=dev), dim=1).values
    kernel = lambda: kbins.conv_bins_depth_batched(x, wts, bias, centers)  # noqa: E731
    plain = lambda: kbins.conv_bins_depth_batched_plain(x, wts, bias, centers)  # noqa: E731
    err = check_close("bins", kernel(), plain(), BINS_RTOL, BINS_ATOL)
    ms, plain_ms = compare_times(kernel, plain)
    log(f"kernel bins {BINS_SHAPE}: max_abs_err {err} (rtol 1e-5, atol 1e-5); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"resize": resize, "bins": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}}


def make_provider(rng: np.random.Generator, n_obj: int):
    """A stand-in detector: per image a different number of valid slots (one
    image fills all of them), boxes inside the frame, CLIP-scale features."""
    counts = [3, 17, 40, 1, 120, n_obj, 64, 8]

    def provider(normed: np.ndarray) -> dict:
        b = normed.shape[0]
        feats = np.zeros((b, n_obj, 512), np.float32)
        xywh = np.full((b, n_obj, 4), -1.0, np.float32)
        valid = np.zeros((b, n_obj), bool)
        for i in range(b):
            k = counts[i % len(counts)]
            feats[i, :k] = 0.05 * rng.standard_normal((k, 512))
            xywh[i, :k] = np.stack([rng.uniform(0, EVAL_DIMS[1], k), rng.uniform(0, EVAL_DIMS[0], k),
                                    rng.uniform(8, 300, k), rng.uniform(8, 300, k)], -1)
            valid[i, :k] = True
        return {"features": feats, "xywh": xywh, "valid": valid}

    return provider


def check_depth(name: str, depth: torch.Tensor, lo: float, hi: float) -> None:
    shape = (BATCH, EVAL_DIMS[0] // 2, EVAL_DIMS[1] // 2, 1)
    if tuple(depth.shape) != shape or depth.dtype != torch.float32:
        raise AssertionError(f"{name}: depth {depth.dtype} {tuple(depth.shape)}, want fp32 {shape}")
    if not torch.isfinite(depth).all():
        raise AssertionError(f"{name}: non-finite depth")
    # bin widths are normalised in bf16, so the last bin edge may pass
    # max_depth by the rounding of their sum (<= 2^-8 relative)
    dmin, dmax = float(depth.min()), float(depth.max())
    if dmin < lo or dmax > hi * (1 + 2.0 ** -8):
        raise AssertionError(f"{name}: depth in [{dmin}, {dmax}], outside [{lo}, {hi}]")
    log(f"  {name}: depth {tuple(depth.shape)} in [{dmin:.4f}, {dmax:.4f}] m, "
        f"std {float(depth.std()):.4f}")


def check_served_kernels(model, records: list[dict]) -> None:
    """Each kernel's output in the served forwards against its plain version
    on the same inputs, at the kernel phase's tolerances."""
    for i, rec in enumerate(records):
        resize, (depth, plain_depth) = plain_outputs(model, rec)
        errs = [check_close(f"request {i} resize {j + 1}", y, want, RESIZE_RTOL, RESIZE_ATOL)
                for j, (y, want) in enumerate(resize)]
        err = check_close(f"request {i} bins", depth, plain_depth, BINS_RTOL, BINS_ATOL)
        spread = float(plain_depth.max() - plain_depth.min())
        band = BINS_ATOL + BINS_RTOL * float(plain_depth.abs().max())
        log(f"  request {i}: served kernels vs plain on their own inputs: resize max abs err "
            f"{max(errs)}, bins max abs err {err} (depth spread {spread:.5f} m, "
            f"{spread / band:.0f}x the bins tolerance)")
        if spread < MIN_SPREAD_IN_TOLERANCES * band:
            raise AssertionError(f"request {i}: depth too flat to check the bins kernel")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def check_against_fp32(model, rng: np.random.Generator) -> None:
    """The same weights in fp32 (the plain versions, which an fp32 model runs
    on the card, and cuDNN convs without TF32) against the bf16 kernel path,
    on a small input with objects: ObjCAViT's outputs, i.e. the encoder, the
    decoder with its four upsamples, and the transformer."""
    small = (384, 352)
    ref_model = build_flagship_pipeline(dtype=torch.float32, seed=0).model
    small_frames = rng.integers(0, 256, (2, *small, 3), dtype=np.uint8)
    outs = []
    for m in (model, ref_model):
        provider = make_provider(np.random.default_rng(5), image_seq_len(*small))
        with record_kernel_io(m) as rec:
            DepthPipeline(m, eval_dims=small, provider=provider)(small_frames)
        outs.append(rec[0]["objcavit"])
    (_, feat, queries), (_, feat_ref, queries_ref) = outs
    rels = {"feat": rel_l2(feat, feat_ref), "queries": rel_l2(queries, queries_ref)}
    log(f"  bf16 kernels vs fp32 plain, 2x{small}: ObjCAViT outputs rel L2 err "
        f"{', '.join(f'{k} {v:.5f}' for k, v in rels.items())} (bound {FEATURE_REL_BOUND})")
    if not max(rels.values()) < FEATURE_REL_BOUND:
        raise AssertionError("the bf16 kernel path strays from the fp32 reference")


def phase_slice() -> dict:
    t0 = time.perf_counter()
    pipe = build_flagship_pipeline(dtype=torch.bfloat16, eval_dims=EVAL_DIMS, seed=0)
    model = pipe.model
    log(f"slice: GraphBins-B5 bf16 folded, {pipe.n_obj_max} slots, built in "
        f"{time.perf_counter() - t0:.2f} s")
    if pipe.n_obj_max != 300:
        raise AssertionError(f"expected 300 object slots at 480x640, got {pipe.n_obj_max}")
    rng = np.random.default_rng(1234)
    with_objects = DepthPipeline(model, eval_dims=EVAL_DIMS,
                                 provider=make_provider(rng, pipe.n_obj_max))
    frames = [rng.integers(0, 256, (BATCH, *EVAL_DIMS, 3), dtype=np.uint8) for _ in range(4)]
    routes = [("objects", with_objects), ("sentinel", pipe), ("objects", with_objects),
              ("sentinel", pipe)]

    pipe(frames[0])  # warm-up: cuDNN set-up, library load
    torch.cuda.synchronize()
    kresize.resize_bilinear_align_corners.launches = 0
    kbins.conv_bins_depth_batched.launches = 0
    with record_kernel_io(model) as records:
        depths = [server(f) for (_, server), f in zip(routes, frames)]
    torch.cuda.synchronize()
    launches = {
        "resize": kresize.resize_bilinear_align_corners.launches,
        "bins": kbins.conv_bins_depth_batched.launches,
    }
    n = len(routes)
    log(f"  {n} requests of {BATCH} frames: launches {launches}")
    if launches != {"resize": 4 * n, "bins": n}:
        raise AssertionError(f"want 4 resize and 1 bins launch per forward, got {launches}")
    for i, ((route, _), depth) in enumerate(zip(routes, depths)):
        check_depth(f"request {i} ({route})", depth, model.min_depth, model.max_depth)
    slots = with_objects.provider(np.zeros((BATCH, 1, 1, 3), np.float32))["valid"].sum(1)
    log(f"  valid object slots per image on the objects route: {slots.tolist()}")
    check_served_kernels(model, records)
    del records

    check_against_fp32(model, rng)

    # served rate: host uint8 frames in, device depth out, one request at a time
    torch.cuda.reset_peak_memory_stats()
    n_req = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_req):
        pipe(frames[i % len(frames)])
    torch.cuda.synchronize()
    served = n_req * BATCH / (time.perf_counter() - t0)
    latencies = []
    for i in range(11):
        t1 = time.perf_counter()
        pipe(frames[i % len(frames)])
        torch.cuda.synchronize()
        latencies.append(1000 * (time.perf_counter() - t1))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  served {served:.2f} img/s over {n_req} requests of {BATCH} (sentinel route); "
        f"p50 {statistics.median(latencies):.2f} ms per request; peak memory {peak_gib:.3f} GiB")
    return launches


def main() -> None:
    name = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_slice()
    print(json.dumps({"kernels": [
        {"name": "resize_bilinear_align_corners_nhwc_bf16", "route": "cuda",
         "source": "objcavit_torch/csrc/resize_bilinear.cu",
         "replaces": "objcavit_tpu/ops/resize_pallas.py:104",
         "launches": launches["resize"], **kernels["resize"]},
        {"name": "conv_bins_depth_batched", "route": "cuda",
         "source": "objcavit_torch/csrc/bins_depth.cu",
         "replaces": "objcavit_tpu/ops/pallas_bins.py:214",
         "launches": launches["bins"], **kernels["bins"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
