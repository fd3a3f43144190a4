"""Tracing and profiling on the card.

Port of ``objcavit_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` trace (host and, where a card is
  present, CUDA activities) of the block, written into ``logdir`` as a
  Chrome trace (``chrome://tracing``, Perfetto or TensorBoard's profile
  plugin read it); without ``logdir`` nothing is written and the caller
  reads the yielded profiler (``profile_stages.trace`` does);
* ``annotate(name)``: a named range on the trace's timeline
  (``record_function``), mirrored onto the card's;
* ``enable_nan_debugging()``: autograd's anomaly mode with its NaN check,
  so a backward that makes a NaN raises at the operator that made it;
* ``device_memory_stats()``: each card's bytes in use, peak and limit.
"""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with record_function(name):
        yield


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
