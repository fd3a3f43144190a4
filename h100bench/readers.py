"""The arithmetic of the per-layer metrics, over one run's readings.

``readings`` holds what a driver measured: ``window`` (the untraced window:
``images``, ``seconds``, ``steps``, ``latencies_s``, ``enqueue_s``),
``flops_per_image`` (``instrument.flops_per_image``), ``trace`` (the traced
window's ``trace.summarize``), ``launches`` (``{"bound_s": {kind: s}}``),
``stages`` (``instrument.Stages.ms_per_image``) and ``traced_steps``. A
reader whose readings are missing returns None and its metric is left out
of the run's line; a share of a peak or a roofline is never made up.
"""

from __future__ import annotations

import statistics

from h100bench.peaks import BF16_PER_S

PROGRAM_KERNELS = "kernel "  # the prefix of the program's kinds (trace.kernel_kind)


def idle_pct(r: dict):
    t = r.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(r: dict):
    w, flops = r.get("window"), r.get("flops_per_image")
    if not w or not flops or not w.get("images"):
        return None
    return 100.0 * flops * w["images"] / w["seconds"] / BF16_PER_S


def roofline_pct(r: dict, kinds=None):
    """The launches' least time over the device time, summed over the kernel
    kinds ``kinds`` (by default every program kernel in the trace): a kind
    the hooks did not count adds its time alone, a kind the trace did not
    see adds nothing."""
    t, launches = r.get("trace"), r.get("launches")
    if not t or not launches:
        return None
    if kinds is None:
        kinds = [k for k in t["by_kind_s"] if k.startswith(PROGRAM_KERNELS)]
    spent = {k: t["by_kind_s"].get(k, 0.0) for k in kinds}
    bound = sum(launches["bound_s"].get(k, 0.0) for k, s in spent.items() if s > 0)
    if bound <= 0:
        return None
    return 100.0 * bound / sum(spent.values())


def stage_ms(r: dict, name: str):
    s = r.get("stages")
    return None if not s else s[name]


def enqueue_ms(r: dict):
    w = r.get("window")
    if not w or not w.get("enqueue_s"):
        return None
    return 1000.0 * statistics.fmean(w["enqueue_s"])


def latency_p50_ms(r: dict):
    w = r.get("window")
    if not w or not w.get("latencies_s"):
        return None
    return 1000.0 * statistics.median(w["latencies_s"])


def launches_per_step(r: dict):
    t, steps = r.get("trace"), r.get("traced_steps")
    if not t or not steps:
        return None
    return t["device_ops"] / steps
