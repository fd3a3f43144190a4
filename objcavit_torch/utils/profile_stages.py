"""Where the time of the flagship server and train step goes, on one CUDA card.

    python -m objcavit_torch.utils.profile_stages          # the server
    python -m objcavit_torch.utils.profile_stages --train  # the train step
    python -m objcavit_torch.utils.profile_stages --fused  # the fused server
    python -m objcavit_torch.utils.profile_stages --attn   # both attention routes
    python -m objcavit_torch.utils.profile_stages --encoder  # both encoder routes
    python -m objcavit_torch.utils.profile_stages --final-upscale  # do_final_upscale
    python -m objcavit_torch.utils.profile_stages --export  # exported programs

Server: three measurements of ``build_flagship_pipeline()`` (GraphBins-B5, bf16, BN
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

Train step (``--train``): ``build_flagship_train()`` (GraphBins-B5, bs 8,
416x544, 221 slots, bf16 compute, fp32 parameters): the stage split by CUDA
events (augmentation, forward, loss, backward, clip + AdamW + schedule),
median of 5 steps after 3 warm-ups, and one trace of 3 steps read as the
server's is, with its peak memory.

Fused server (``--fused``): ``build_fused_flagship()`` (GraphBins-B5 and
YOLOv7-seg bf16, BN folded, 1203 classes, random weights) at NYU 480x640
(300 slots) and KITTI 352x1216 (418 slots), bs 8, on each head route, the
class-max kernel (kernel 6) and the dense head: the stage split by CUDA
events (preprocess, detector backbone and neck, detect head, decode and
NMS, table gather and sentinel, GraphBins), median of 20 requests after 5
warm-ups; one trace of 5 requests at NYU, read as the server's is; served
img/s over 20 requests and latency p50/p90 of 21 synchronised requests,
with peak memory, twice per route in turns.

Attention routes (``--attn``): the stage split of the flagship server and
of the AdaBins-B5 server (``build_adabins_pipeline``, 480x640, bs 8) on the
plain attention route and on kernel 5's, two servers built from one seed
(the same weights), timed in turns (plain, kernel, kernel, plain;
``route_split``): the ObjCAViT and miniViT stages are what the route
changes.

Encoder routes (``--encoder``): the flagship server on the plain encoder
route and on kernels 7 and 8's (``encoder_impl``), two servers of one seed:
the stage split in turns, as ``--attn``, and one trace of 5 requests per
route, read as the server's is.

Final upscale (``--final-upscale``): AdaBins-B5 and GraphBins-B5 with
``do_final_upscale`` (full-resolution features; 1000 slots) on kernel 5's
route: each server's stage split and one trace of 5 requests, read as the
server's is, then AdaBins-B5's full-resolution train step's split and
trace, read as ``--train``'s.

Export (``--export``): ``profile_export``'s two servers beside their
exported programs, in turns.

Each line names the card (``nvidia-smi``) at the start and at the end.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from objcavit_torch.serving import build_adabins_pipeline, build_flagship_pipeline
from objcavit_torch.utils.profiling import served_rate
from objcavit_torch.utils.profiling import trace_calls as trace
from objcavit_torch.utils.benchkit import build_adabins_train, build_flagship_train

SMI = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
       "--format=csv,noheader"]
STAGES = ("preprocess", "encoder", "decoder", "objcavit", "bins_head")
TRAIN_STAGES = ("augment", "forward", "loss", "backward", "optimizer")
FUSED_STAGES = ("preprocess", "backbone_neck", "detect_head", "decode_nms", "gather_sentinel",
                "graphbins")


def smi() -> str:
    return subprocess.run(SMI, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def stage_split(pipe, frames, iters: int = 30, warmup: int = 10) -> dict:
    """Median ms of each stage of one served request, by CUDA events from
    forward hooks: preprocess, encoder, decoder, the transformer head
    (named by its class: 'objcavit' for GraphBins, 'minivit' for AdaBins),
    bins head, total."""
    model = pipe.model
    dfe = model.dense_feature_extractor
    head = model.transformer_head
    head_name = type(head).__name__.lower()
    events: dict[str, torch.cuda.Event] = {}

    def mark(name):
        def hook(*_):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()
        return hook

    stages = [(dfe.encoder["original_model"], "encoder"), (dfe.decoder, "decoder"),
              (head, "objcavit")]
    handles = [m.register_forward_pre_hook(mark(f"{n}_in")) for m, n in stages]
    handles += [m.register_forward_hook(mark(f"{n}_out")) for m, n in stages + [(model, "model")]]
    bounds = ["start", "encoder_in", "encoder_out", "decoder_in", "decoder_out",
              "objcavit_in", "objcavit_out", "model_out"]
    labels = [head_name if st == "objcavit" else st for st in STAGES]
    pairs = dict(zip(labels, [(0, 1), (1, 2), (3, 4), (5, 6), (6, 7)]))
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


def route_split(pipes: dict, frames, attr: str, iters: int = 20, warmup: int = 5) -> dict:
    """{route: stage_split} of ``pipes`` ({'plain': server, 'kernel':
    server}, one model's weights on each route of the model's ``attr``,
    'attn_impl' or 'encoder_impl'), timed in turns (plain, kernel, kernel,
    plain; each route's two splits averaged)."""
    for route, pipe in pipes.items():
        if getattr(pipe.model, attr) != route:
            raise ValueError(f"the {route!r} server's model has {attr} "
                             f"{getattr(pipe.model, attr)!r}")
    runs = collections.defaultdict(list)
    for route in ("plain", "kernel", "kernel", "plain"):
        runs[route].append(stage_split(pipes[route], frames, iters, warmup))
    return {route: {k: statistics.mean(r[k] for r in splits) for k in splits[0]}
            for route, splits in runs.items()}


def profile_attention_routes() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    for name, build in (("flagship", build_flagship_pipeline), ("adabins", build_adabins_pipeline)):
        pipes = {route: build(attn_impl=route) for route in ("plain", "kernel")}
        frames = rng.integers(0, 256, (8, *pipes["plain"].eval_dims, 3), dtype=np.uint8)
        for route, split in route_split(pipes, frames, "attn_impl").items():
            print(f"{name} stage_ms_median ({route} attention)", json.dumps(split), flush=True)


def profile_encoder_routes() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipes = {route: build_flagship_pipeline(encoder_impl=route) for route in ("plain", "kernel")}
    frames = np.random.default_rng(0).integers(0, 256, (8, *pipes["plain"].eval_dims, 3),
                                               dtype=np.uint8)
    for route, split in route_split(pipes, frames, "encoder_impl").items():
        print(f"stage_ms_median ({route} encoder)", json.dumps(split), flush=True)
    for route, pipe in pipes.items():
        t = trace(lambda: pipe(frames))
        print(t.pop("top"), flush=True)
        print(f"trace ({route} encoder)", json.dumps(t), flush=True)


def train_stage_split(step, batch, objects, iters: int = 8, warmup: int = 3) -> dict:
    """Median ms of each part of ``step`` (a ``training.steps.TrainStep``),
    by CUDA events: augmentation up to the model's forward, the forward, the
    loss, the backward, and the update (clip, AdamW, schedule)."""
    events: dict[str, torch.cuda.Event] = {}

    def mark(name):
        def hook(*_):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()
        return hook

    model = step.model
    handles = [model.register_forward_pre_hook(mark("forward_in")),
               model.register_forward_hook(mark("forward_out"))]
    bounds = ["start", "forward_in", "forward_out", "loss_out", "backward_out", "end"]
    times = collections.defaultdict(list)
    try:
        for it in range(iters):
            mark("start")()
            loss = step.loss(batch, objects)
            mark("loss_out")()
            loss.backward()
            mark("backward_out")()
            step.update()
            mark("end")()
            torch.cuda.synchronize()
            if it < warmup:
                continue
            for stage, a, b in zip(TRAIN_STAGES, bounds, bounds[1:]):
                times[stage].append(events[a].elapsed_time(events[b]))
            times["total"].append(events["start"].elapsed_time(events["end"]))
    finally:
        for h in handles:
            h.remove()
    return {k: statistics.median(v) for k, v in times.items()}


def fused_stage_split(pipe, frames, iters: int = 25, warmup: int = 5) -> dict:
    """Median ms of each stage of one ``FusedDepthPipeline`` request, by CUDA
    events from forward hooks on the detector's body, the detector and
    GraphBins, and from a wrapper around the pipeline's ``_detections``."""
    events: dict[str, torch.cuda.Event] = {}

    def mark(name):
        def hook(*_):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()
        return hook

    det, model = pipe.detector, pipe.model
    handles = [det.body.register_forward_pre_hook(mark("body_in")),
               det.body.register_forward_hook(mark("body_out")),
               det.register_forward_hook(mark("head_out")),
               model.register_forward_pre_hook(mark("model_in")),
               model.register_forward_hook(mark("model_out"))]
    detections = pipe._detections

    def timed_detections(x):
        out = detections(x)
        mark("nms_out")()
        return out

    pipe._detections = timed_detections
    bounds = ["start", "body_in", "body_out", "head_out", "nms_out", "model_in", "model_out"]
    times = collections.defaultdict(list)
    try:
        for it in range(iters):
            mark("start")()
            pipe(frames)
            mark("end")()
            torch.cuda.synchronize()
            if it < warmup:
                continue
            for stage, a, b in zip(FUSED_STAGES, bounds, bounds[1:]):
                times[stage].append(events[a].elapsed_time(events[b]))
            times["total"].append(events["start"].elapsed_time(events["end"]))
    finally:
        del pipe._detections
        for h in handles:
            h.remove()
    return {k: statistics.median(v) for k, v in times.items()}


def profile_fused() -> None:
    """Both head routes at NYU 480x640 (18,900 anchors, 300 slots) and KITTI
    352x1216 (26,334 anchors, 418 slots), bs 8: the stage split and the
    served rate of each, timed in turns (kernel, dense, dense, kernel) so
    that the host's drift hits both, and one trace on each route at NYU."""
    from objcavit_torch.serving import FusedDepthPipeline, build_fused_flagship

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nyu = build_fused_flagship()
    rng = np.random.default_rng(0)
    for dims in ((480, 640), (352, 1216)):
        pipe = nyu if dims == nyu.eval_dims else FusedDepthPipeline(
            nyu.model, nyu.detector, nyu.class_table, eval_dims=dims)
        frames = [rng.integers(0, 256, (8, *dims, 3), dtype=np.uint8) for _ in range(2)]
        rates = collections.defaultdict(list)
        for head in (True, False, False, True):
            pipe.class_max_head = head
            route = "class-max kernel" if head else "dense head"
            print(f"fused {dims} stage_ms_median ({route})",
                  json.dumps(fused_stage_split(pipe, frames[0])), flush=True)
            if not rates[route] and dims == nyu.eval_dims:
                t = trace(lambda: pipe(frames[0]))
                print(t.pop("top"), flush=True)
                print(f"fused {dims} trace ({route})", json.dumps(t), flush=True)
            rates[route].append(served_rate(pipe, frames))
            print(f"fused {dims} served ({route})", json.dumps(rates[route][-1]), flush=True)


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


def profile_train() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step, batch, objects = build_flagship_train()
    print("train_stage_ms_median", json.dumps(train_stage_split(step, batch, objects)), flush=True)
    torch.cuda.reset_peak_memory_stats()
    t = trace(lambda: step(batch, objects), n_req=3)
    print(t.pop("top"), flush=True)
    print("train_trace (per step)", json.dumps(t), flush=True)
    print(f"train peak {torch.cuda.max_memory_allocated() / 2**30:.4f} GiB", flush=True)


def profile_final_upscale() -> None:
    frames = np.random.default_rng(0).integers(0, 256, (8, 480, 640, 3), dtype=np.uint8)
    for name, build in (("adabins", build_adabins_pipeline), ("graphbins", build_flagship_pipeline)):
        pipe = build(attn_impl="kernel", do_final_upscale=True)
        print(f"stage_ms_median ({name}, final upscale, {pipe.n_obj_max} slots)",
              json.dumps(stage_split(pipe, frames)), flush=True)
        t = trace(lambda: pipe(frames))
        print(t.pop("top"), flush=True)
        print(f"trace ({name}, final upscale)", json.dumps(t), flush=True)
        del pipe
        torch.cuda.empty_cache()
    step, batch = build_adabins_train(attn_impl="kernel", do_final_upscale=True)
    print("train_stage_ms_median (adabins, final upscale)",
          json.dumps(train_stage_split(step, batch, None)), flush=True)
    t = trace(lambda: step(batch, None), n_req=3)
    print(t.pop("top"), flush=True)
    print("train trace (adabins, final upscale)", json.dumps(t), flush=True)


def enqueue_ms(run, frames, n: int = 15) -> float:
    """Median host ms of ``run(frames)`` returning, the card idle before each."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(frames)
        times.append(1000 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def profile_export() -> None:
    """Two of ``chip_smoke.py`` phase 16's servers, the flagship on kernel 5's
    and kernels 7 and 8's routes (bs 8) and AdaBins-B5 with do_final_upscale
    on kernel 5's (bs 1), each beside its exported program
    (``serving_export``, held in this process as ``ServingArtifact`` runs
    it), in turns (eager, program, program, eager): a request's host
    enqueue ms, the program's also with its per-call input check, and the
    served rate and p50."""
    from objcavit_torch.serving_export import ServingArtifact, export_pipeline

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    for what, build, batch in (
            ("flagship, kernel routes", lambda: build_flagship_pipeline(
                attn_impl="kernel", encoder_impl="kernel"), 8),
            ("AdaBins final upscale", lambda: build_adabins_pipeline(
                attn_impl="kernel", do_final_upscale=True), 1)):
        pipe = build()
        frames = rng.integers(0, 256, (batch, *pipe.eval_dims, 3), dtype=np.uint8)
        pipe(frames)
        program, weights = export_pipeline(pipe, frames.shape)
        program.example_inputs = None  # as a saved and loaded program
        art = ServingArtifact(program, weights, {"platforms": ["cuda"],
                                                 "frames_shape": list(frames.shape)})
        art(frames)

        def checked(f):
            art._module.validate_inputs = True
            return art(f)

        out = collections.defaultdict(list)
        for side in ("eager", "program", "program", "eager"):
            run = pipe if side == "eager" else art
            out[f"{side} enqueue ms"].append(enqueue_ms(run, frames))
            if side == "program":
                out["program enqueue ms, input check on"].append(enqueue_ms(checked, frames))
            r = served_rate(run, [frames], n_req=10, n_lat=7)
            out[f"{side} img/s"].append(r["img_per_s"])
            out[f"{side} p50 ms"].append(r["p50_ms"])
        print(f"export, {what}, bs {batch}", json.dumps(out), flush=True)
        del pipe, art, program, weights
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--train", action="store_true", help="profile the train step")
    parser.add_argument("--fused", action="store_true", help="profile the fused server")
    parser.add_argument("--attn", action="store_true",
                        help="stage splits of the flagship and AdaBins on each attention route")
    parser.add_argument("--encoder", action="store_true",
                        help="stage splits and traces of the flagship on each encoder route")
    parser.add_argument("--final-upscale", action="store_true",
                        help="stage splits and traces of the do_final_upscale servers and step")
    parser.add_argument("--export", action="store_true",
                        help="host cost and served rate of exported programs beside eager")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_stages: needs a CUDA card")
    print(smi(), flush=True)
    other = (profile_train if args.train else profile_fused if args.fused
             else profile_attention_routes if args.attn
             else profile_encoder_routes if args.encoder
             else profile_final_upscale if args.final_upscale
             else profile_export if args.export else None)
    if other is not None:
        other()
        print(smi(), flush=True)
        return
    pipe = build_flagship_pipeline()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, *pipe.eval_dims, 3), dtype=np.uint8)
    print("stage_ms_median", json.dumps(stage_split(pipe, frames)), flush=True)
    t = trace(lambda: pipe(frames))
    print(t.pop("top"), flush=True)
    print("trace", json.dumps(t), flush=True)
    for line in sweep(pipe, rng):
        print(line, flush=True)
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
