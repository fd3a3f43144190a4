"""The program's spans and counters over a ``--trace 1`` run's profiler
window (``trace.Profiled``): the ranges that
``objcavit_torch/utils/profiling.py::annotate`` opens, read from the same
events as ``trace.summarize``, on the profiler's own clock. No second
profiler, no second window.

* idle by span: the device's idle gaps, taken as ``trace.summarize`` takes
  them, each cut along its whole length by the innermost program span open
  on the window's thread; a piece under none is ``UNSPANNED``. The pieces
  add up to the window's idle time. Beside them, each span's idle time
  whatever span is open inside it (``serving.forward``'s holds its
  ``model.*`` spans');
* host time by span: each span's host time inside the window, and how many
  spans of each name the window holds;
* device time by span: each device operation's time inside the window,
  under the innermost program span that was open on the window's thread
  when its launch ran (the runtime call with the operation's correlation
  id), not when it ran; an operation launched outside every span, or on
  another thread, is ``UNSPANNED``.

``summarize(events)`` gives a window's ``spans`` reading and
``counters_since(before)`` its ``counters`` (the change in the program's
``profiling.counters()``, empty for a program without them). The readers
below take a run's readings with those two keys and return None where
either is missing, as ``readers.py`` does.
"""

from __future__ import annotations

import bisect
import collections

from h100bench.trace import WINDOW, _is_device, union

PROGRAM = ("serving.", "stream.", "model.")  # the prefixes of the program's span names
UNSPANNED = "unspanned"
RUNTIME = "cu"  # the CUDA API calls: cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync


def is_span(e) -> bool:
    return e.name.startswith(PROGRAM)


class Timeline:
    """The innermost program span at each instant of one thread: the spans
    (which nest) cut the time axis into pieces, each under one name."""

    def __init__(self, spans):
        cuts = sorted({t for e in spans for t in (e.time_range.start, e.time_range.end)})
        self.cuts = cuts
        self.names = [UNSPANNED] * max(len(cuts) - 1, 0)
        for e in sorted(spans, key=lambda e: (e.time_range.start, -e.time_range.end)):
            # a span opened later lies inside those opened before it and covers them
            lo = bisect.bisect_left(cuts, e.time_range.start)
            hi = bisect.bisect_left(cuts, e.time_range.end)
            self.names[lo:hi] = [e.name] * (hi - lo)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.names[i] if 0 <= i < len(self.names) else UNSPANNED

    def split(self, a: float, b: float) -> collections.Counter:
        """[a, b)'s length by the innermost span over each piece."""
        points = [a, *self.cuts[bisect.bisect_right(self.cuts, a):bisect.bisect_left(self.cuts, b)], b]
        out = collections.Counter()
        for p, q in zip(points, points[1:]):
            out[self.at(p)] += q - p
        return out


def summarize(events) -> dict:
    """``events``: the profiler's ``events()`` over a window annotated
    ``trace.WINDOW``. -> seconds by program span name (see the module note)."""
    host = [e for e in events if not _is_device(e)]
    window = next(e for e in host if e.name == WINDOW)
    w0, w1 = window.time_range.start, window.time_range.end
    device = [e for e in events if _is_device(e) and e.name != WINDOW
              and not getattr(e, "is_user_annotation", False)
              and e.time_range.end > w0 and e.time_range.start < w1]
    busy = union((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device)
    spans = [e for e in host if e.thread == window.thread and is_span(e)]
    line = Timeline(spans)
    gaps, edge = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle = collections.Counter()
    for a, b in gaps:
        idle.update(line.split(a, b))
    starts = [a for a, _ in gaps]
    host_us, idle_in, count = collections.Counter(), collections.Counter(), collections.Counter()
    for e in spans:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        host_us[e.name] += max(0.0, b - a)
        count[e.name] += 1
        for g0, g1 in gaps[max(bisect.bisect_right(starts, a) - 1, 0):bisect.bisect_left(starts, b)]:
            idle_in[e.name] += max(0.0, min(b, g1) - max(a, g0))
    launches = {e.id: e for e in host if e.name.startswith(RUNTIME)}
    device_us = collections.Counter()
    for e in device:
        launch = launches.get(e.id)
        name = (line.at(launch.time_range.start)
                if launch is not None and launch.thread == window.thread else UNSPANNED)
        device_us[name] += min(e.time_range.end, w1) - max(e.time_range.start, w0)
    return {
        "window_s": (w1 - w0) / 1e6,
        "idle_s": {k: v / 1e6 for k, v in idle.items()},
        "idle_in_s": {k: v / 1e6 for k, v in idle_in.items()},
        "host_s": {k: v / 1e6 for k, v in host_us.items()},
        "count": dict(count),
        "device_s": {k: v / 1e6 for k, v in device_us.items()},
    }


def program_counters() -> dict:
    """The program's counters now; {} where the program has none."""
    try:
        from objcavit_torch.utils.profiling import counters
    except ImportError:
        return {}
    return counters()


def counters_since(before: dict) -> dict:
    """The change in the program's counters since ``before``
    (``program_counters()`` taken at the window's start)."""
    return {k: v - before.get(k, 0) for k, v in program_counters().items()}


def _spans(r: dict):
    s = r.get("spans")
    return s if s and s["count"] else None


def idle_pct(r: dict, name: str):
    """% of the window with the device idle while a ``name`` span is open
    (whatever span is open inside it); ``UNSPANNED`` for the time under no
    span."""
    s = _spans(r)
    if s is None:
        return None
    if name == UNSPANNED:
        idle = s["idle_s"].get(UNSPANNED, 0.0)
    elif name in s["count"]:
        idle = s["idle_in_s"].get(name, 0.0)
    else:
        return None
    return 100.0 * idle / s["window_s"]


def _per(r: dict, counter: str):
    s, c = _spans(r), r.get("counters") or {}
    return (None, 0) if s is None or not c.get(counter) else (s, c[counter])


def host_ms_per_batch(r: dict, name: str):
    s, batches = _per(r, "serving.batches")
    if s is None or name not in s["count"]:
        return None
    return 1000.0 * s["host_s"][name] / batches


def device_ms_per_image(r: dict, *names: str):
    """Device ms an image of the operations launched under ``names``."""
    s, images = _per(r, "serving.images")
    if s is None or not any(n in s["count"] for n in names):
        return None
    return 1000.0 * sum(s["device_s"].get(n, 0.0) for n in names) / images


def h2d_pinned_pct(r: dict):
    c = r.get("counters") or {}
    pinned, pageable = c.get("serving.h2d_pinned_bytes", 0), c.get("serving.h2d_pageable_bytes", 0)
    if pinned + pageable <= 0:
        return None
    return 100.0 * pinned / (pinned + pageable)
