"""Where the time of the flagship server goes, on one CUDA card.

    python -m objcavit_torch.utils.profile_stages

Three measurements of ``build_flagship_pipeline()`` (GraphBins-B5, bf16, BN
folded, 480x640, 300 slots, random weights, sentinel objects):

1. the stage split: CUDA events, recorded by forward hooks, around the
   stages of one served request of 8 frames (preprocess up to the encoder,
   encoder, decoder, ObjCAViT, bins head), median of 20 after 10 warm-ups;
2. one ``torch.profiler`` trace of 5 requests: device kernels per request,
   device time per request by kind of kernel, the top operators, and the
   device's idle share, all read from that one trace (the union of the
   device's kernel and copy intervals over the traced window). The profiler
   slows the host, so the idle share it reads is an upper bound;
3. a batch sweep: served img/s over a run of requests, latency p50/p90 of
   21 synchronised requests, and peak memory, at bs 1, 8, 16 and 32, with
   ``cudnn.benchmark`` off and on.

Each line names the card (``nvidia-smi``) at the start and at the end.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from objcavit_torch.serving import build_flagship_pipeline

SMI = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
       "--format=csv,noheader"]
STAGES = ("preprocess", "encoder", "decoder", "objcavit", "bins_head")


def smi() -> str:
    return subprocess.run(SMI, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def stage_split(pipe, frames, iters: int = 30, warmup: int = 10) -> dict:
    model = pipe.model
    dfe = model.dense_feature_extractor
    events: dict[str, torch.cuda.Event] = {}

    def mark(name):
        def hook(*_):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()
        return hook

    stages = [(dfe.encoder["original_model"], "encoder"), (dfe.decoder, "decoder"),
              (model.objcavit, "objcavit")]
    handles = [m.register_forward_pre_hook(mark(f"{n}_in")) for m, n in stages]
    handles += [m.register_forward_hook(mark(f"{n}_out")) for m, n in stages + [(model, "model")]]
    bounds = ["start", "encoder_in", "encoder_out", "decoder_in", "decoder_out",
              "objcavit_in", "objcavit_out", "model_out"]
    pairs = dict(zip(STAGES, [(0, 1), (1, 2), (3, 4), (5, 6), (6, 7)]))
    times = collections.defaultdict(list)
    try:
        for it in range(iters):
            mark("start")()
            pipe(frames)
            mark("end")()
            torch.cuda.synchronize()
            if it < warmup:
                continue
            for stage, (a, b) in pairs.items():
                times[stage].append(events[bounds[a]].elapsed_time(events[bounds[b]]))
            times["total"].append(events["start"].elapsed_time(events["end"]))
    finally:
        for h in handles:
            h.remove()
    return {k: statistics.median(v) for k, v in times.items()}


def kernel_kind(name: str) -> str:
    n = name.lower()
    for needle, kind in (("conv_bins_depth", "kernel 2 (bins)"),
                         ("resize_bilinear", "kernel 1 (resize)"), ("memcpy", "memcpy")):
        if needle in n:
            return kind
    if any(k in n for k in ("fprop", "conv2d_c1_k1", "cudnn", "implicit_gemm")):
        return "cudnn conv"
    if any(k in n for k in ("nvjet", "gemm", "wmma", "cutlass")):
        return "gemm"
    for needle, kind in (("reduce_kernel", "reduction"), ("softmax", "softmax"),
                         ("cat", "concat"), ("elementwise", "elementwise")):
        if needle in n:
            return kind
    return "other"


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def trace(pipe, frames, n_req: int = 5) -> dict:
    pipe(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("requests"):
            for _ in range(n_req):
                pipe(frames)
            torch.cuda.synchronize()
    events = prof.events()
    on_device = [str(e.device_type).endswith("CUDA") for e in events]
    window = next(e for e, d in zip(events, on_device) if e.name == "requests" and not d).time_range
    # the trace mirrors the annotation on the device's timeline: not a kernel
    device = [e for e, d in zip(events, on_device) if d and e.name != "requests"]
    busy = union_us((e.time_range.start, e.time_range.end) for e in device)
    by_kind = collections.Counter()
    for e in device:
        by_kind[kernel_kind(e.name)] += e.time_range.elapsed_us()
    ka = prof.key_averages()
    attr = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    return {
        "window_ms_per_request": window.elapsed_us() / 1000 / n_req,
        "device_kernels_per_request": len(device) / n_req,
        "device_busy_ms_per_request": busy / 1000 / n_req,
        "idle_share": 1 - busy / window.elapsed_us(),
        "device_ms_per_request_by_kind": {k: v / 1000 / n_req for k, v in by_kind.most_common()},
        "top": ka.table(sort_by=attr, row_limit=25, max_name_column_width=80),
    }


def sweep(pipe, rng) -> list[str]:
    lines = []
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for b in (1, 8, 16, 32):
            fb = [rng.integers(0, 256, (b, *pipe.eval_dims, 3), dtype=np.uint8) for _ in range(2)]
            for f in fb:
                pipe(f)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n = max(10, 160 // b)
            t0 = time.perf_counter()
            for i in range(n):
                pipe(fb[i % 2])
            torch.cuda.synchronize()
            rate = n * b / (time.perf_counter() - t0)
            lat = []
            for i in range(21):
                t1 = time.perf_counter()
                pipe(fb[i % 2])
                torch.cuda.synchronize()
                lat.append(1000 * (time.perf_counter() - t1))
            lat.sort()
            lines.append(
                f"cudnn.benchmark={bench} bs={b}: served {rate:.3f} img/s over {n} requests; "
                f"latency p50 {lat[10]:.3f} ms, p90 {lat[18]:.3f} ms (21 requests); "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.4f} GiB"
            )
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_stages: needs a CUDA card")
    print(smi(), flush=True)
    pipe = build_flagship_pipeline()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, *pipe.eval_dims, 3), dtype=np.uint8)
    print("stage_ms_median", json.dumps(stage_split(pipe, frames)), flush=True)
    t = trace(pipe, frames)
    print(t.pop("top"), flush=True)
    print("trace", json.dumps(t), flush=True)
    for line in sweep(pipe, rng):
        print(line, flush=True)
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
