"""What the two serving drivers share: the program's ``DepthPipeline`` over
the seed's weights, the pool of frames, and the check of the window's depth
maps against the plain reference.

The check takes a sample of the window's requests, drawn from the seed
(``check_batches`` of them, a reservoir over the window, so any request is
as likely), and runs the reference on each request's own frames, in blocks
of ``REFERENCE_BLOCK`` images, once the program's model is freed: in fp32
with TF32 off, and the same reference with its BatchNorms folded in fp32
and cast to bf16 (its bins head still fp32), as a served model is. Its
number is ``depth_err_ratio``: over the sample's images, the root mean
square of the program's errors over that of the bf16 reference's, each
error ||depth - fp32 reference|| / ||fp32 reference|| of one image. A ratio and not the error itself: random models
differ from seed to seed in how far they carry a rounding to the depth
(the program's error reads 0.1% to 1.5% over twelve seeds, the fp8
control's 0.7% to 15%, overlapping), and the bf16 reference's error
measures that for the seed and its images.
"""

from __future__ import annotations

import contextlib
import gc

from h100bench.common import (
    CALIBRATION_FRAMES,
    Cell,
    calibrate_batchnorm_,
    calibrate_logits_,
    dtype_of,
    exact_fp32,
    make_frames,
    port_model,
    reference_model,
)

POOL_FRAMES = 64  # frames made at set-up from the seed, which the mix's requests draw on
REFERENCE_BLOCK = 8  # images a reference forward in the check


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn with ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class Server:
    def __init__(self, cell: Cell):
        import torch

        from h100bench.reference import model as ref
        from objcavit_torch.serving import DepthPipeline
        from objcavit_torch.utils.fold_bn import fold_batchnorm

        self.cell = cell
        serve, traffic = cell.config["serve"], cell.traffic
        self.h, self.w = serve["eval_dims"]
        self.slots = serve["slots"]
        self.batch = traffic["batch_size"]
        self.attempted = self.failed = 0
        self.samples: list = []
        self.takes_objects = ref.MODELS[cell.config["model"]].takes_objects
        self.obj_dim = cell.config["kwargs"].get("obj_feature_dim", 512)
        self.pool = make_frames(cell, POOL_FRAMES, self.h, self.w)
        reference = reference_model(cell)
        calib = torch.as_tensor(self.pool[:CALIBRATION_FRAMES], device=cell.device)
        calibrate_batchnorm_(reference, *self.reference_inputs(calib))
        calibrate_logits_(reference, *self.reference_inputs(calib))
        self.state = {k: v.detach().to("cpu", copy=True)
                      for k, v in reference.state_dict().items()}
        del reference
        model = port_model(cell, {k: v.to(cell.device) for k, v in self.state.items()}, serve)
        fold_batchnorm(model.eval())
        model.cast(dtype_of(serve["dtype"]))
        self.model = model.to(memory_format=torch.channels_last)
        self.pipe = DepthPipeline(self.model, eval_dims=(self.h, self.w), n_obj_max=self.slots)

    def reference_inputs(self, frames):
        from h100bench.reference import model as ref

        x = ref.normalise(frames)
        if not self.takes_objects:
            return (x,)
        return (x, *ref.sentinel_objects(x.shape[0], self.slots, self.obj_dim, x.device))

    def flops_per_image(self) -> float:
        from h100bench.instrument import flops_per_image

        return flops_per_image(self.cell.config, 1, self.h, self.w, self.slots, train=False)

    def free_program(self) -> None:
        import torch

        self.pipe = self.model = None
        gc.collect()
        if torch.device(self.cell.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype):
        import torch

        from h100bench.reference import model as ref

        with torch.device("meta"):
            model = ref.build(self.cell.config["model"], self.cell.config["kwargs"])
        model = model.to_empty(device=self.cell.device)
        model.load_state_dict(self.state)
        if dtype != torch.float32:  # folded in fp32, then cast, as a served model is
            ref.fold_batchnorm_(model.eval())
        return model.eval().to(dtype)

    def checks(self, control: bool = False) -> dict:
        import torch

        from h100bench.reference.precision import Fp8Compute, round_parameters_

        fp32, bf16 = self.reference(torch.float32), self.reference(torch.bfloat16)
        fp8 = round_parameters_(self.reference(torch.bfloat16)) if control else None
        block = REFERENCE_BLOCK
        errors, scale = [], []
        with exact_fp32(), torch.no_grad():
            for frames, depth in self.samples:
                for i in range(0, len(frames), block):
                    inputs = self.reference_inputs(
                        torch.as_tensor(frames[i:i + block], device=self.cell.device))
                    want = fp32(*inputs)[0]
                    scale.append(rel_l2(bf16(*low(inputs))[0], want))
                    if control:
                        with Fp8Compute():
                            got = fp8(*low(inputs))[0]
                    else:
                        got = torch.as_tensor(depth[i:i + block], device=self.cell.device)
                    errors.append(rel_l2(got, want))
        return {"depth_err_ratio": float(rms(torch.cat(errors)) / rms(torch.cat(scale)))}


def low(inputs) -> tuple:
    """The floating inputs cast to bf16 (inside ``Fp8Compute``, then to fp8)."""
    import torch

    return tuple(t.to(torch.bfloat16) if t.is_floating_point() else t for t in inputs)


def rms(t):
    return t.square().mean().sqrt()


def rel_l2(got, want):
    """Each image's ||got - want|| / ||want||."""
    return (got.float() - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)


@contextlib.contextmanager
def hooked(*instruments):
    for i in instruments:
        i.install()
    try:
        yield
    finally:
        for i in instruments:
            i.remove()
