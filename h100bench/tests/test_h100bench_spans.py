"""``spans.py`` on made-up events: the idle gaps cut by the innermost program
span add up to the window's idle time; a device operation goes to the span
open at its launch, not at its run; a reading without the program's spans
or counters gives None; and ``trace.summarize`` reads the same window as it
did."""

import types

import pytest

from h100bench import spans, trace

MAIN, FEEDER = 1, 2


def event(name, start, end, device=False, thread=MAIN, id=0, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        time_range=types.SimpleNamespace(start=start, end=end), thread=thread, id=id,
        is_user_annotation=annotation)


def kernel(name, launch, start, end, id, thread=MAIN):
    """A device operation and the runtime call that launched it."""
    return [event("cudaLaunchKernel", launch, launch + 1, thread=thread, id=id),
            event(name, start, end, device=True, id=id)]


def window():
    """One batch of a stream in a 0-200 us window: the feeder wait, the
    request with its copy, normalise and forward (encoder, decoder), the
    host copy and the finish; the card idle while the host launches."""
    return [
        event(trace.WINDOW, 0, 200, annotation=True),
        event(trace.WINDOW, 0, 200, device=True, annotation=True),
        event("stream.feed_wait", 0, 20, annotation=True),
        event("serving.request", 20, 150, annotation=True),
        event("serving.h2d", 22, 30, annotation=True),
        event("serving.forward", 40, 140, annotation=True),
        event("model.encoder", 45, 90, annotation=True),
        event("aten::conv", 50, 60),
        event("model.decoder", 90, 135, annotation=True),
        event("model.encoder", 90, 135, device=True, annotation=True),  # a device mirror
        event("stream.host_copy", 150, 155, annotation=True),
        event("stream.finish", 160, 190, annotation=True),
        *kernel("memcpy_htod", 25, 26, 32, id=101),
        *kernel("enc_a", 50, 52, 80, id=102),
        # launched inside the encoder, run while the decoder launches
        *kernel("enc_b", 85, 100, 120, id=103),
        *kernel("dec_a", 95, 120, 170, id=104),
        *kernel("memcpy_dtoh", 152, 170, 175, id=105),
        # a copy launched on another thread, run in the feeder's wait
        *kernel("memcpy_other", 5, 8, 12, id=106, thread=FEEDER),
    ]


def test_idle_pieces_add_up_to_the_window_idle_time():
    events = window()
    s = spans.summarize(events)
    t = trace.summarize(events)
    idle = t["window_s"] - t["busy_s"]
    assert sum(s["idle_s"].values()) == pytest.approx(idle)
    # gaps: [0, 8) [12, 26) [32, 52) [80, 100) [175, 200), 87 us
    us = {k: pytest.approx(v * 1e-6) for k, v in {
        "stream.feed_wait": 8 + 8, "serving.request": 2 + 8, "serving.h2d": 4,
        "serving.forward": 5, "model.encoder": 7 + 10, "model.decoder": 10,
        "stream.finish": 15, spans.UNSPANNED: 10}.items()}
    assert s["idle_s"] == us
    # a span's own idle time holds the spans inside it
    assert s["idle_in_s"]["serving.forward"] == pytest.approx((5 + 17 + 10) * 1e-6)
    assert s["idle_in_s"]["serving.request"] == pytest.approx((10 + 4 + 32) * 1e-6)
    r = {"spans": s}
    pieces = (spans.idle_pct(r, "serving.forward") + spans.idle_pct(r, "stream.feed_wait")
              + sum(spans.idle_pct(r, k) for k in ("serving.h2d", "stream.host_copy",
                                                   "stream.finish", spans.UNSPANNED))
              + 100 * s["idle_s"]["serving.request"] / s["window_s"])
    assert pieces == pytest.approx(100 * (1 - t["busy_s"] / t["window_s"]))


def test_host_time_and_counts_by_span():
    s = spans.summarize(window())
    assert s["count"]["model.encoder"] == 1 and s["count"]["serving.request"] == 1
    assert s["host_s"]["serving.forward"] == pytest.approx(100e-6)
    assert s["window_s"] == pytest.approx(200e-6)
    r = {"spans": s, "counters": {"serving.batches": 2, "serving.images": 32,
                                  "serving.h2d_pageable_bytes": 300,
                                  "serving.h2d_pinned_bytes": 100}}
    assert spans.host_ms_per_batch(r, "stream.feed_wait") == pytest.approx(20e-3 / 2)
    assert spans.h2d_pinned_pct(r) == pytest.approx(25.0)


def test_a_kernel_goes_to_the_span_open_at_its_launch():
    s = spans.summarize(window())
    us = {k: pytest.approx(v * 1e-6) for k, v in {
        "serving.h2d": 6, "model.encoder": 28 + 20, "model.decoder": 50,
        "stream.host_copy": 5, spans.UNSPANNED: 4}.items()}
    assert s["device_s"] == us
    r = {"spans": s, "counters": {"serving.images": 4}}
    assert spans.device_ms_per_image(r, "model.encoder") == pytest.approx(48e-3 / 4)
    assert spans.device_ms_per_image(r, "model.decoder", "model.bins_head") == pytest.approx(
        50e-3 / 4)


def test_missing_spans_or_counters_give_none():
    bare = [e for e in window() if not spans.is_span(e)]  # a program without spans
    r = {"spans": spans.summarize(bare), "counters": {}}
    assert spans.idle_pct(r, spans.UNSPANNED) is None
    assert spans.idle_pct(r, "serving.forward") is None
    assert spans.host_ms_per_batch(r, "serving.forward") is None
    assert spans.device_ms_per_image(r, "model.encoder") is None
    assert spans.h2d_pinned_pct(r) is None
    full = {"spans": spans.summarize(window())}
    assert spans.idle_pct(full, "model.attention") is None  # no such span in the window
    assert spans.idle_pct(full, "serving.output") is None
    assert spans.idle_pct(full, "stream.host_copy") == 0.0  # present, never idle
    assert spans.host_ms_per_batch(full, "serving.forward") is None  # no counters
    assert spans.device_ms_per_image({}, "model.encoder") is None


def test_trace_summary_of_the_window_is_unchanged_by_the_spans():
    """The spans are annotations: the card's busy time, its operations and
    the breakdown's device operations read as without them."""
    events = window()
    bare = [e for e in events if not spans.is_span(e)]
    with_spans, without = trace.summarize(events), trace.summarize(bare)
    for key in ("window_s", "busy_s", "device_ops", "by_kind_s", "by_name_s"):
        assert with_spans[key] == without[key], key


def test_counters_since_reads_the_program():
    from objcavit_torch.utils import profiling

    before = spans.program_counters()
    profiling.count("test.spans", 2)
    assert spans.counters_since(before)["test.spans"] == 2
