"""The yardstick's arithmetic on the CPU: each kernel's roofline count
against a hand count at one shape, the trace's busy time and idle gaps on
made-up events, and the readers' shares."""

import types

import pytest
import torch

from h100bench import instrument, peaks, readers, trace


def roofline(name):
    return next(m for m in instrument.roofline_files() if m.__name__.endswith(name))


def module(**kw):
    return types.SimpleNamespace(training=False, **kw)


def bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def test_k1_concat_form_at_up1():
    # B5's up1 at 480x640, bs 8: x (8, 2048, 16, 21) -> (30, 40) beside a 176-channel skip
    x, skip = bf16(8, 2048, 16, 21), bf16(8, 176, 30, 40)
    [launch] = roofline("k1_resize").launches(module(), (x, skip), None)
    assert launch["bytes"] == 2 * 8 * (2048 * 16 * 21 + 176 * 1200 + 2224 * 1200)
    assert launch["fp32"] == 6 * 8 * 2048 * 1200
    assert roofline("k1_resize").launches(module(), (x.float(), skip.float()), None) == []


def test_k2_bins_at_the_served_shape():
    feat = bf16(8, 240, 320, 128)
    [launch] = roofline("k2_bins").launches(module(), (), (None, feat, None))
    s = 240 * 320
    assert launch["bytes"] == 2 * 8 * s * 128 + 2 * 8 * 128 * 256 + 4 * 256 + 4 * 8 * 256 + 4 * 8 * s
    assert launch["bf16"] == 2 * 8 * s * 128 * 256
    t, by = peaks.bound_s(launch["bytes"], launch["bf16"])
    assert by == "bytes" and t == pytest.approx(launch["bytes"] / 3.35e12)


def test_k4_forward_and_backward_in_training():
    feat = bf16(8, 208, 272, 128)
    m = module()
    m.training = True
    fwd, bwd = roofline("k4_bins_expectation").launches(m, (), (None, feat, None))
    s, k = 208 * 272, 256
    assert fwd == {"bytes": 2 * 8 * s * k + 4 * 8 * k + 4 * 8 * s, "fp32": 5 * 8 * s * k}
    assert bwd == {"bytes": 4 * 8 * s * k + 8 * 8 * k + 4 * 8 * s, "fp32": 8 * 8 * s * k}


def test_k5_served_forward():
    q = bf16(16, 300, 128)
    m = module(attn_impl="kernel", num_heads=4)
    [launch] = roofline("k5_attention").launches(m, (q, q, q), None)
    # q, k, v read and o written (bf16 rows of H * D = 128), the fp32 key bias read
    assert launch["bytes"] == 2 * 16 * 128 * (4 * 300) + 4 * 16 * 300
    assert launch["bf16"] == 2 * 2 * 16 * 4 * 300 * 300 * 32
    assert roofline("k5_attention").launches(module(attn_impl="plain", num_heads=4),
                                             (q, q, q), None) == []


def test_k7_and_k8_at_a_b5_block():
    from objcavit_torch.models.common import MBConv

    block = MBConv(40, 40, 6, 5, 1, fused_mbconv_head=True, se_project=True).to("meta")
    block.route = lambda: "mbconv_head"
    x = bf16(8, 40, 60, 80)
    [k8] = roofline("k8_mbconv").launches(block, (x,), x)
    n, m = 8 * 60 * 80, 240
    assert k8["bytes"] == 2 * n * (40 + m) + 2 * 25 * m + 4 * m + 4 * 8 * m + 2 * 40 * m + 4 * m
    assert k8["bf16"] == 2 * n * 40 * m and k8["fp32"] == 2 * 25 * n * m
    assert roofline("k7_se_project").launches(block, (x,), x) == []
    block.route = lambda: "se_project"
    [k7] = roofline("k7_se_project").launches(block, (x,), x)
    assert k7["bytes"] == 2 * n * m + 2 * 8 * m + 2 * m * 40 + 4 * 40 + 2 * n * 40 * 2
    assert k7["bf16"] == 2 * n * m * 40


def event(name, start, end, device=False, thread=1):
    return types.SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        time_range=types.SimpleNamespace(start=start, end=end), thread=thread)


def test_trace_busy_union_and_named_gaps():
    events = [event(trace.WINDOW, 0, 100), event("step", 0, 100),
              event("aten::conv", 10, 20), event("cudaLaunchKernel", 12, 14),
              event("k_a", 5, 30, device=True), event("mbconv_kernel<3>", 20, 40, device=True),
              event("k_c", 60, 90, device=True)]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(65e-6) and s["window_s"] == pytest.approx(100e-6)
    assert s["device_ops"] == 3
    assert s["by_kind_s"]["kernel 8 (MBConv head)"] == pytest.approx(20e-6)
    # gaps: [0, 5) under "step"'s span, [40, 60) and [90, 100) too
    assert s["idle_by_host_s"] == {"step": pytest.approx(35e-6)}
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["k_c", pytest.approx(30e-6)]


def test_readers_leave_out_what_they_cannot_read():
    assert readers.idle_pct({}) is None
    assert readers.roofline_pct({"trace": {"by_kind_s": {"gemm": 1.0}},
                                 "launches": {"bound_s": {}}}) is None
    r = {"trace": {"busy_s": 0.5, "window_s": 2.0,
                   "by_kind_s": {"kernel 8 (MBConv head)": 2e-3, "kernel 7 (SE-gate project)": 1e-3,
                                 "gemm": 5e-3}},
         "launches": {"bound_s": {"kernel 8 (MBConv head)": 1e-3}},
         "window": {"images": 100, "seconds": 2.0}, "flops_per_image": 989e9}
    assert readers.idle_pct(r) == pytest.approx(75.0)
    # kernel 7 ran with no count: its time counts, its bound does not
    assert readers.roofline_pct(r) == pytest.approx(100 * 1e-3 / 3e-3)
    assert readers.roofline_pct(r, ["kernel 8 (MBConv head)"]) == pytest.approx(50.0)
    assert readers.mfu_pct(r) == pytest.approx(100 * 989e9 * 50 / 989e12)


def test_flops_per_image_of_the_served_b5():
    config = {"model": "graphbins", "kwargs": {"encoder_name": "efficientnet-b5", "n_bins": 256,
                                               "pos_strategy": "learned_bbox_wh"}}
    served = instrument.flops_per_image(config, 1, 480, 640, 300, train=False)
    assert 360e9 < served < 390e9  # the JAX package counts 363.3 GFLOPs, the factored head
