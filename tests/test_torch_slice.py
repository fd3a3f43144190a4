"""Slice 1 end to end: objcavit_torch's GraphBins and DepthPipeline against
objcavit_tpu's, on the CPU, at efficientnet-tiny with 32 bins, B=2, 384x352.

The same JAX variables (from tests/test_torch_modules.py) feed both sides;
inputs are uint8 frames and object slots from seeded numpy RNGs. JAX's
pipeline runs without a mesh (``use_mesh=False``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objcavit_tpu.serving import DepthPipeline as JaxDepthPipeline
from objcavit_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm

from objcavit_torch.serving import DepthPipeline, build_flagship_pipeline, image_seq_len
from objcavit_torch.utils.benchkit import build_flagship, build_flagship_model
from objcavit_torch.utils.fold_bn import fold_batchnorm
from objcavit_torch.utils.kernel_io import plain_outputs, record_kernel_io, skip_mismatches
from objcavit_torch.utils.profiling import union_us
from tests.test_torch_modules import (
    H,
    W,
    graphbins_variables,
    jax_graphbins,
    port_graphbins,
)

B, N = 2, 4


def _objects(rng, counts=(3, 1), n=N):
    feats = np.zeros((B, n, 512), np.float32)
    xywh = np.full((B, n, 4), -1.0, np.float32)
    valid = np.zeros((B, n), bool)
    for i, c in enumerate(counts):
        feats[i, :c] = rng.standard_normal((c, 512))
        xywh[i, :c] = np.stack([rng.uniform(0, W, c), rng.uniform(0, H, c),
                                rng.uniform(10, 120, c), rng.uniform(10, 120, c)], -1)
        valid[i, :c] = True
    return feats, xywh, valid


def _run_both(dtype_name: str, fold: bool):
    variables = graphbins_variables()
    rng = np.random.default_rng(7)
    img = (0.5 * rng.standard_normal((B, H, W, 3))).astype(np.float32)
    objs = _objects(rng)

    jvars = jax_fold_batchnorm(variables) if fold else variables
    jmodel = jax_graphbins(dtype=getattr(jnp, dtype_name), fold_bn=fold)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        jvars, *map(jnp.asarray, (img, *objs))
    )

    model = port_graphbins(variables)
    if fold:
        fold_batchnorm(model)
    model.cast(getattr(torch, dtype_name))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (img, *objs)))
    return got, want


def test_graphbins_fp32_matches_jax():
    """Tolerances of tests/test_fullmodel_oracle.py: depth 1e-3, edges 1e-4."""
    got, want = _run_both("float32", fold=False)
    assert got["depth_pred"].shape == (B, H // 2, W // 2, 1)
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["depth_pred"].numpy(), np.asarray(want["depth_pred"]),
                               rtol=1e-3, atol=1e-3)


def test_graphbins_bf16_folded_matches_jax():
    """The main path's form: BN folded, then bf16. The frameworks round to
    bf16 at different points (JAX's CPU path rounds the range maps and the
    logits to bf16, and its bf16 resize rounds between the H and W passes;
    the port keeps the logits in fp32 and rounds once per resize), so depth
    is held to its spread, not to fp32 tolerances. Measured on this input:
    max 0.075 m, mean 0.016 m, correlation 0.985 over a depth spread
    (std) of 0.097 m; the bounds are twice those gaps."""
    got, want = _run_both("bfloat16", fold=True)
    depth = got["depth_pred"].numpy()
    ref = np.asarray(want["depth_pred"])
    assert np.isfinite(depth).all()
    np.testing.assert_allclose(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]),
                               rtol=0, atol=0.04)
    gap = np.abs(depth - ref)
    assert gap.max() < 0.15 and gap.mean() < 0.03, (gap.max(), gap.mean())
    assert np.corrcoef(depth.ravel(), ref.ravel())[0, 1] > 0.97


def _provider(normed: np.ndarray) -> dict:
    """A stand-in detector: fixed object slots, two valid in image 0, one in 1."""
    assert normed.shape == (B, H, W, 3)
    feats, xywh, valid = _objects(np.random.default_rng(11), counts=(2, 1), n=6)
    return {"features": feats, "xywh": xywh, "valid": valid}


@pytest.mark.parametrize(
    "frame_hw,provider,at_input_res",
    [((H, W), None, False), ((300, 400), _provider, True)],
    ids=["sentinel-eval-size", "provider-resized"],
)
def test_depth_pipeline_matches_jax(frame_hw, provider, at_input_res):
    variables = graphbins_variables()
    frames = np.random.default_rng(13).integers(0, 256, (B, *frame_hw, 3), dtype=np.uint8)
    jpipe = JaxDepthPipeline(jax_graphbins(), variables, eval_dims=(H, W), use_mesh=False,
                             provider=provider, output_at_input_res=at_input_res)
    pipe = DepthPipeline(port_graphbins(variables), eval_dims=(H, W), provider=provider,
                         output_at_input_res=at_input_res)
    assert pipe.n_obj_max == jpipe.n_obj_max == image_seq_len(H, W) == 132
    want = np.asarray(jpipe(frames))
    got = pipe(frames).numpy()
    out_hw = frame_hw if at_input_res else (H // 2, W // 2)
    assert got.shape == want.shape == (B, *out_hw, 1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_depth_pipeline_rejects_non_uint8_frames():
    pipe = DepthPipeline(port_graphbins(graphbins_variables()), eval_dims=(H, W))
    with pytest.raises(ValueError, match="uint8"):
        pipe(np.zeros((1, H, W, 3), np.float32))


def test_flagship_builders():
    """The flagship is B5 with 256 bins, folded (no BN left), bf16 apart
    from the fp32 conv_out, channels_last; its pipeline serves 300 slots at
    480x640. Built on the CPU, not run."""
    pipe = build_flagship_pipeline(device="cpu")
    model = pipe.model
    assert pipe.n_obj_max == 300 and pipe.eval_dims == (480, 640)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert {d for n, d in dtypes.items() if not n.startswith("conv_out")} == {torch.bfloat16}
    assert model.conv_out[0].weight.dtype == torch.float32
    stem = model.dense_feature_extractor.encoder["original_model"].conv_stem.weight
    assert stem.shape == (48, 3, 3, 3) and stem.is_contiguous(memory_format=torch.channels_last)
    head = model.dense_feature_extractor.encoder["original_model"].conv_head.weight
    assert head.shape == (2048, 512, 1, 1)
    # same seed, same weights
    again = build_flagship_model(device="cpu")
    assert torch.equal(again.conv_out[0].weight, model.conv_out[0].weight)
    assert torch.equal(again.objcavit.obj_embedding_layer.weight,
                       model.objcavit.obj_embedding_layer.weight)


def test_build_flagship_inputs_and_forward_tiny():
    """build_flagship's inputs drive the model forward (tiny encoder override
    of the flagship builder keeps this fast)."""
    model, inputs = build_flagship(2, H, W, n_obj=8, device="cpu")
    img, feats, xywh, valid = inputs
    assert img.shape == (2, H, W, 3) and feats.shape == (2, 8, 512)
    assert xywh.shape == (2, 8, 4) and valid.dtype == torch.bool
    small = build_flagship_model(device="cpu", encoder_name="efficientnet-tiny")
    with torch.no_grad():
        out = small(img, feats, xywh, valid)
    assert out["depth_pred"].shape == (2, H // 2, W // 2, 1)
    assert torch.isfinite(out["depth_pred"]).all()
    assert out["bin_edges"].shape == (2, 257)


def test_record_kernel_io_sees_each_kernel_call_of_a_served_forward():
    """The hooks record the four upsamples and the bins head of every served
    forward; on the CPU the wrappers run the plain versions, so each
    recorded output equals the plain version on the recorded inputs, and
    each concat buffer's skip slice is the skip."""
    model = build_flagship_model(device="cpu", encoder_name="efficientnet-tiny")
    frames = np.random.default_rng(3).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    pipe = DepthPipeline(model, eval_dims=(H, W))
    with record_kernel_io(model) as records:
        depths = [pipe(frames), pipe(frames[:1])]
    pipe(frames)  # hooks gone
    assert len(records) == 2
    for rec, depth in zip(records, depths):
        assert rec["depth"] is depth
        resize, (served, plain) = plain_outputs(model, rec)
        assert [tuple(y.shape[1:3]) for y, _ in resize] == [
            (24, 22), (48, 44), (96, 88), (192, 176)
        ]
        for y, want in resize:
            assert y.dtype == torch.bfloat16 and torch.equal(y, want)
        assert [s.shape[:3] for s, _ in rec["skips"]] == [y.shape[:3] for y, _ in resize]
        assert skip_mismatches(rec) == 0
        assert torch.equal(served, plain)


def test_profile_stages_busy_time_is_the_union_of_intervals():
    assert union_us([(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)]) == 3 + 7 + 1
    assert union_us([]) == 0
