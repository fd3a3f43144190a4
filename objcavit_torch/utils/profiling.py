"""Tracing and profiling on the card.

Port of ``objcavit_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` trace (host and, where a card is
  present, CUDA activities) of the block, written into ``logdir`` as a
  Chrome trace (``chrome://tracing``, Perfetto or TensorBoard's profile
  plugin read it); without ``logdir`` nothing is written and the caller
  reads the yielded profiler (``trace_calls`` does);
* ``annotate(name)``: the program's span, a ``record_function`` range on
  the profiler's own timeline (mirrored onto the card's) while a profiler
  runs, and one shared null context, which records nothing, while none
  runs or while ``torch.export`` or ``torch.compile`` traces; spans opened
  inside one another on a thread nest;
* ``count(name, n)`` and ``counters()``: the program's counters, always
  on, in one dict of ints for the process; ``counters()`` is a copy;
* ``enable_nan_debugging()``: autograd's anomaly mode with its NaN check,
  so a backward that makes a NaN raises at the operator that made it;
* ``device_memory_stats()``: each card's bytes in use, peak and limit;
* ``served_rate(pipe, frames)`` and ``trace_calls(run)``: a server's img/s,
  latency and peak memory, and one trace's device time, idle share and
  kernels by kind (``utils/profile_stages.py`` and ``chip_smoke.py`` read
  them; any callable server, an exported artifact's too).
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import threading
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str | None = None) -> Iterator[profile]:
    """Profile the block (the host, and the card where there is one); with
    ``logdir``, write its trace there as ``trace_<pid>_<ns>.json``. Yields
    the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def annotate(name: str) -> contextlib.AbstractContextManager:
    """``with annotate(name):`` spans the block as ``name`` while a profiler
    runs; else it costs one check of the profiler's state. Never a profiler
    node in an exported or compiled program."""
    if (not torch.autograd._profiler_enabled() or torch.compiler.is_exporting()
            or torch.compiler.is_compiling()):
        return _OFF
    return record_function(name)


def count(name: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def device_memory_stats() -> dict:
    """{'cuda:i': {'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'}} for
    each card (the caching allocator's current and peak bytes, the card's
    total memory); {} without a card, as JAX gives for a device without
    statistics."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return stats


def served_rate(pipe, frames: list, n_req: int = 20, n_lat: int = 21) -> dict:
    """img/s over ``n_req`` requests one after another, latency p50/p90 of
    ``n_lat`` synchronised requests, and the peak memory of both."""
    for f in frames:
        pipe(f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(n_req):
        pipe(frames[i % len(frames)])
    torch.cuda.synchronize()
    rate = n_req * frames[0].shape[0] / (time.perf_counter() - t0)
    lat = []
    for i in range(n_lat):
        t1 = time.perf_counter()
        pipe(frames[i % len(frames)])
        torch.cuda.synchronize()
        lat.append(1000 * (time.perf_counter() - t1))
    return {"img_per_s": rate, "p50_ms": statistics.median(lat),
            "p90_ms": sorted(lat)[int(0.9 * (n_lat - 1))],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def kernel_kind(name: str) -> str:
    n = name.lower()
    for needle, kind in (("attn_", "kernel 5 (attention)"),
                         ("detect_head", "kernel 6 (detect head)"),
                         ("se_project", "kernel 7 (SE-gate project)"),
                         ("mbconv_kernel", "kernel 8 (MBConv head)"),
                         ("pool_reduce", "kernel 8 (MBConv head)"),
                         ("bins_expectation", "kernel 4 (bins expectation)"),
                         ("conv_bins_depth", "kernel 2 (bins)"),
                         ("resize_kernel", "kernel 1 (resize)"), ("memcpy", "memcpy")):
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


def trace_calls(run, n_req: int = 5) -> dict:
    """One ``torch.profiler`` trace of ``n_req`` calls of ``run()``, per call."""
    run()
    torch.cuda.synchronize()
    with trace() as prof:
        with annotate("requests"):
            for _ in range(n_req):
                run()
            torch.cuda.synchronize()
    events = prof.events()
    on_device = [str(e.device_type).endswith("CUDA") for e in events]
    window = next(e for e, d in zip(events, on_device) if e.name == "requests" and not d).time_range
    # the trace mirrors annotations ("requests", the optimizer's step) on the
    # device's timeline: they are not kernels
    device = [e for e, d in zip(events, on_device)
              if d and e.name != "requests" and not getattr(e, "is_user_annotation", False)]
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
