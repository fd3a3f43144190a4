"""Each driver through a whole run on the CPU at a tiny size (the tiny
configurations in fp32, so the program matches the plain reference to
rounding), past the harness's look for a card; then the same runs with the
timed path broken underneath, one fault at a time, each of which has to
turn ``correct`` false."""

import numpy as np
import pytest
import torch

from h100bench import common, control, harness
from h100bench.drivers import train as train_driver

BENCH = common.benchmark(held_back=True)  # the held-back train cell's driver too
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


def run(tiny, workload, trace=False):
    return harness.run_cell(BENCH, workload, SEED, 0.3, trace, "cpu", files=tiny(workload))


@pytest.mark.parametrize("workload", ["graphbins-b5.stream-bs16", "adabins-b5.stream-bs16",
                                      "graphbins-b5.request-bs8", "graphbins-b5.train-bs8"])
def test_a_sound_run_is_correct(tiny, workload):
    r = run(tiny, workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e = {m["name"] for m in harness.reported(BENCH, workload, "end_to_end")}
    assert set(r["metrics"]) == e2e
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_the_same_seed_makes_the_same_inputs(tiny):
    entry, config, traffic, limits = tiny("graphbins-b5.train-bs8")
    cell = common.Cell("x", config, traffic, limits, SEED, "cpu")
    assert np.array_equal(common.make_frames(cell, 2, 16, 24), common.make_frames(cell, 2, 16, 24))
    a = train_driver.make_batches(cell)
    b = train_driver.make_batches(cell)
    assert torch.equal(a[0][1]["depth"], b[0][1]["depth"])


def test_a_traced_run_on_the_cpu_reports_what_it_can(tiny):
    r = run(tiny, "graphbins-b5.request-bs8", trace=True)
    assert r["correct"]
    # no device, no device metrics: the CPU run has no idle share or roofline
    assert "device_idle_pct.request" not in r["metrics"]
    assert set(r["metrics"]) <= {"mfu_pct.request", "enqueue_ms.request",
                                 "request_p50_ms.request"}
    assert r["metrics"]["request_p50_ms.request"]["value"] > 0


def altered_answer(monkeypatch):
    """A served answer altered where it is produced: each request's first
    depth map shifted by 1 m."""
    from objcavit_torch.serving import DepthPipeline

    serve = DepthPipeline.serve

    def broken(self, frames):
        depth = serve(self, frames).clone()
        depth[0] += 1.0
        return depth

    monkeypatch.setattr(DepthPipeline, "serve", broken)


@pytest.mark.parametrize("workload", ["graphbins-b5.stream-bs16", "adabins-b5.stream-bs16",
                                      "graphbins-b5.request-bs8"])
def test_an_altered_answer_is_not_correct(tiny, monkeypatch, workload):
    altered_answer(monkeypatch)
    r = run(tiny, workload)
    assert not r["correct"]
    assert r["checks"]["depth_err_ratio"]["value"] > r["checks"]["depth_err_ratio"]["limit"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tiny, monkeypatch):
    from objcavit_torch.training.steps import TrainStep

    monkeypatch.setattr(TrainStep, "update", lambda self: None)
    r = run(tiny, "graphbins-b5.train-bs8")
    assert not r["correct"]
    assert r["checks"]["step_gap_med"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(tiny, monkeypatch):
    from objcavit_torch.training.steps import TrainStep

    loss = TrainStep.loss

    def half(self, batch, objects):
        b = batch["image"].shape[0] // 2
        batch = {k: v[:b] for k, v in batch.items()}
        objects = None if objects is None else {k: v[:b] for k, v in objects.items()}
        return loss(self, batch, objects)

    monkeypatch.setattr(TrainStep, "loss", half)
    r = run(tiny, "graphbins-b5.train-bs8")
    assert not r["correct"]
    assert r["checks"]["grad_diff_med"]["value"] > r["checks"]["grad_diff_med"]["limit"]


def test_the_half_batch_fault_of_the_control_tool_reads_high(tiny):
    values = control.readings("graphbins-b5.train-bs8", SEED, 0.1, False, "cpu",
                              files=tiny("graphbins-b5.train-bs8"), fault=control.half_batch)
    limits = tiny("graphbins-b5.train-bs8")[3]
    assert values["grad_diff_med"] > limits["grad_diff_med"]


@pytest.mark.parametrize("workload", ["graphbins-b5.stream-bs16", "graphbins-b5.train-bs8"])
def test_the_control_reads_above_the_program(tiny, workload):
    """At the tiny fp32 size the program matches the reference to rounding,
    and the fp8 control does not: the control reads above the program."""
    files = tiny(workload)
    program = control.readings(workload, SEED, 0.1, False, "cpu", files=files)
    fp8 = control.readings(workload, SEED, 0.1, True, "cpu", files=files)
    for name in files[3]:
        assert fp8[name] > 10 * program[name], name
