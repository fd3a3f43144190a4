"""The traced part of a ``--trace 1`` run: one ``torch.profiler`` window
(host and CUDA activities, events kept in memory, nothing written), read
into what the per-layer metrics and the breakdown need.

* busy: the union of the device's kernel and copy intervals inside the
  window (the method of ``objcavit_torch/utils/profiling.py::union_us``,
  copied), so overlapping work on two streams counts once;
* device time by kernel kind (``kernel_kind``, copied from the same file)
  and by kernel name; the count of device operations;
* idle gaps: each stretch of the window with nothing on the device, named
  by the innermost host operation that was running on the main thread at
  the gap's middle ("host idle" where none was), summed by that name.

Annotations that the profiler mirrors onto the device's timeline are not
device work and are left out.
"""

from __future__ import annotations

import bisect
import collections

WINDOW = "h100bench.window"


def kernel_kind(name: str) -> str:
    """The program's kernels by the needles of their CUDA names; the
    libraries' by family."""
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
    if any(k in n for k in ("fprop", "conv2d_c1_k1", "cudnn", "implicit_gemm", "dgrad", "wgrad")):
        return "cudnn conv"
    if any(k in n for k in ("nvjet", "gemm", "wmma", "cutlass")):
        return "gemm"
    for needle, kind in (("reduce_kernel", "reduction"), ("softmax", "softmax"),
                         ("cat", "concat"), ("elementwise", "elementwise")):
        if needle in n:
            return kind
    return "other"


def union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def summarize(events) -> dict:
    """``events``: the profiler's ``events()`` over a window annotated
    ``WINDOW``. -> seconds and counts (see the module note)."""
    host = [e for e in events if not _is_device(e)]
    window = next(e for e in host if e.name == WINDOW)
    w0, w1 = window.time_range.start, window.time_range.end
    device = [e for e in events if _is_device(e) and e.name != WINDOW
              and not getattr(e, "is_user_annotation", False)
              and e.time_range.end > w0 and e.time_range.start < w1]
    spans = union((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device)
    busy_us = sum(b - a for a, b in spans)
    by_kind, by_name = collections.Counter(), collections.Counter()
    for e in device:
        us = e.time_range.end - e.time_range.start
        by_kind[kernel_kind(e.name)] += us
        by_name[e.name] += us
    gaps, edge = [], w0
    for a, b in spans:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    idle = _name_gaps(gaps, [e for e in host if e.thread == window.thread and e is not window])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": len(device),
        "by_kind_s": {k: v / 1e6 for k, v in by_kind.items()},
        "by_name_s": {k: v / 1e6 for k, v in by_name.items()},
        "idle_by_host_s": {k: v / 1e6 for k, v in idle.items()},
    }


def _name_gaps(gaps, host) -> collections.Counter:
    """Each gap's length under the innermost host event running at its
    middle (host events of one thread nest), summed by name."""
    host = sorted(host, key=lambda e: (e.time_range.start, -e.time_range.end))
    starts = [e.time_range.start for e in host]
    out = collections.Counter()
    stack: list = []
    i = 0
    for a, b in sorted(gaps):
        t = 0.5 * (a + b)
        hi = bisect.bisect_right(starts, t)
        while i < hi:
            e = host[i]
            while stack and stack[-1].time_range.end < e.time_range.start:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1].time_range.end < t:
            stack.pop()
        out[stack[-1].name if stack else "host idle"] += b - a
    return out


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    operations the device waited on longest, in seconds."""
    top = collections.Counter(summary["by_name_s"]).most_common(10)
    gaps = collections.Counter(summary["idle_by_host_s"]).most_common(10)
    return {"device_ops": [[n[:200], s] for n, s in top],
            "idle_gaps": [[n[:200], s] for n, s in gaps]}


class Profiled:
    """A profiler started and stopped by hand around a window of a loop that
    runs on, with the window's annotation: ``start()``, ``stop()``, then
    ``summary()``."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if str(device).startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.mark = record_function(WINDOW)
        self.device = device

    def start(self) -> None:
        self.prof.start()
        self.mark.__enter__()

    def stop(self) -> None:
        from h100bench.common import sync

        sync(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> dict:
        return summarize(self.prof.events())
