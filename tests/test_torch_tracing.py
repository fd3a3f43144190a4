"""The port's spans and counters (``utils/profiling.py``): ``annotate`` off
(no ``record_function``, one shared null context) while no profiler runs
and while ``torch.export`` traces; on a CPU profiler, every span of the
serving path and the model's stages once a batch of ``stream_depth``,
nested as the layers are; the counters against the batches, images and
frame bytes served; and the depth maps the same with spans on and off.

The servers are efficientnet-tiny GraphBins and AdaBins with 16 bins at
64x96 and random weights, on one torch thread (the Tier-1 command runs six
workers).
"""

import collections
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from objcavit_torch.models.adabins import AdaBins
from objcavit_torch.models.graphbins import GraphBins
from objcavit_torch.serving import DepthPipeline, device_frames, stream_depth
from objcavit_torch.serving_export import export_pipeline
from objcavit_torch.utils import profiling
from objcavit_torch.utils.benchkit import init_weights_

DIMS = (64, 96)
N_OBJ = 4
BATCH = 2
FRAMES = 5  # three batches, the last padded
SERVING = ("serving.request", "serving.h2d", "serving.normalise", "serving.forward",
           "serving.output")
STREAM = ("stream.feed_wait", "stream.host_copy", "stream.finish")
MODEL = ("model.encoder", "model.decoder", "model.attention", "model.bins_head")
SPANS = SERVING + STREAM + MODEL


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_pipeline(kind: str) -> DepthPipeline:
    model = (GraphBins if kind == "graphbins" else AdaBins)(
        encoder_name="efficientnet-tiny", n_bins=16, n_queries=5)
    with torch.no_grad():
        init_weights_(model, torch.Generator().manual_seed(0))
    return DepthPipeline(model, eval_dims=DIMS, n_obj_max=N_OBJ)


def frames(n: int = FRAMES) -> list:
    return list(np.random.default_rng(7).integers(0, 256, (n, *DIMS, 3), dtype=np.uint8))


def raising_record_function(name):
    raise AssertionError(f"record_function({name!r}) called")


def test_annotate_off_calls_no_record_function(monkeypatch):
    monkeypatch.setattr(profiling, "record_function", raising_record_function)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("a") is profiling.annotate("b")
    with profiling.annotate("serving.request"):
        pass
    out = list(stream_depth(tiny_pipeline("graphbins"), iter(frames()), BATCH))
    assert len(out) == 3


def test_annotate_on_is_a_range_on_the_profiler_timeline():
    with profiling.trace() as prof:
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(8) + 1
    ev = {e.name: e for e in prof.events()}
    assert ev["inner"].cpu_parent is ev["outer"]
    assert ev["outer"].time_range.start <= ev["inner"].time_range.start
    assert ev["inner"].time_range.end <= ev["outer"].time_range.end


def program_parent(e):
    """The nearest enclosing program span of the event ``e``, or None."""
    p = e.cpu_parent
    while p is not None and p.name not in SPANS:
        p = p.cpu_parent
    return p


@pytest.mark.parametrize("kind", ["graphbins", "adabins"])
def test_stream_gives_every_span_once_a_batch_nested_by_layer(kind):
    pipe = tiny_pipeline(kind)
    before = profiling.counters()
    with profiling.trace() as prof:
        traced = list(stream_depth(pipe, iter(frames()), BATCH))
    events = [e for e in prof.events() if e.name in SPANS]
    n = collections.Counter(e.name for e in events)
    batches = len(traced)
    # the feeder's queue is read once more, for the stream's end
    assert n == {**{s: batches for s in SPANS}, "stream.feed_wait": batches + 1}
    want = {"model.encoder": "serving.forward", "model.decoder": "serving.forward",
            "model.attention": "serving.forward", "model.bins_head": "serving.forward",
            "serving.forward": "serving.request", "serving.h2d": "serving.request",
            "serving.normalise": "serving.request", "serving.output": "serving.request",
            "serving.request": None, "stream.feed_wait": None, "stream.host_copy": None,
            "stream.finish": None}
    for e in events:
        parent = program_parent(e)
        assert (parent and parent.name) == want[e.name], e.name
    # a batch's spans in the stream's order: its request, its host copy, then
    # (once the next batch is launched) the previous batch's finish
    order = [e.name for e in sorted(events, key=lambda e: e.time_range.start)
             if e.name in ("serving.request", "stream.host_copy", "stream.finish")]
    assert order == ["serving.request", "stream.host_copy"] + [
        "serving.request", "stream.host_copy", "stream.finish"] * (batches - 1) + ["stream.finish"]
    after = profiling.counters()
    assert after["serving.batches"] - before.get("serving.batches", 0) == batches
    assert after["serving.images"] - before.get("serving.images", 0) == batches * BATCH

    untraced = list(stream_depth(pipe, iter(frames()), BATCH))
    direct = [pipe(np.stack(frames()[i:i + BATCH])).numpy() for i in (0, 2)]
    for (f1, d1), (f2, d2) in zip(traced, untraced):
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(d1, d2)
    for (_, d), want_depth in zip(traced, direct):
        np.testing.assert_array_equal(d, want_depth)


def test_counters_count_requests_and_the_host_copy():
    pipe = tiny_pipeline("graphbins")
    before = profiling.counters()
    pipe(np.stack(frames(3)))
    after = profiling.counters()
    assert after["serving.batches"] - before.get("serving.batches", 0) == 1
    assert after["serving.images"] - before.get("serving.images", 0) == 3
    # frames already where the model is: no copy, no bytes
    for kind in ("pageable", "pinned"):
        key = f"serving.h2d_{kind}_bytes"
        assert after.get(key, 0) == before.get(key, 0)
    # a copy off the host counts its bytes (the meta device stands for a card)
    batch = np.stack(frames(2))
    device_frames(batch, "meta")
    copied = profiling.counters()
    assert (copied["serving.h2d_pageable_bytes"] - after.get("serving.h2d_pageable_bytes", 0)
            == batch.nbytes)
    assert copied.get("serving.h2d_pinned_bytes", 0) == after.get("serving.h2d_pinned_bytes", 0)


def test_counters_lose_no_update_across_threads():
    before = profiling.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [profiling.count("test.threads", 3)
                                                     for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counters()["test.threads"] - before == 16 * 2000 * 3


def test_export_under_a_profiler_holds_no_profiler_node(monkeypatch):
    pipe = tiny_pipeline("graphbins")
    shape = (BATCH, *DIMS, 3)
    with profiling.trace():
        monkeypatch.setattr(profiling, "record_function", raising_record_function)
        program, _ = export_pipeline(pipe, shape)
    targets = [str(node.target) for node in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]


def test_annotate_is_the_one_span_api_of_the_port():
    root = pathlib.Path(profiling.__file__).resolve().parents[1]
    callers = [p.relative_to(root).as_posix() for p in root.rglob("*.py")
               if "record_function" in p.read_text()]
    assert callers == ["utils/profiling.py"]
