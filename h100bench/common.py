"""What every driver of the benchmark shares: the cell's files, the weights
and inputs made from the seed, the program's model built from those
weights, the card's checks and the comparison's report.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``: its ``config``
names a file under ``h100bench/configs/`` (through ``configs[].file``) and
its ``traffic`` the file ``h100bench/traffic/<traffic>.json``, whose
``driver`` names the module ``h100bench/drivers/<driver>.py``. The limits
of its correctness check are in ``h100bench/limits/<workload>.json``.

Weights: one ``torch.Generator`` on the device, seeded with the run's seed,
fills every parameter of the plain reference model in one draw, PyTorch's
default initialisers' ranges: convolutions and linear layers U(+-1/sqrt(fan
in)), attention's input projections Xavier-uniform with zero biases,
LayerNorms at identity, BatchNorm affines ``BN_WEIGHT`` and ``BN_BIAS``,
positional tables U[0, 1). With the statistics below, each BN's output is
about N(1, 0.25): SiLU and LeakyReLU work near their linear range, so a
perturbation does not grow layer by layer, as in a trained network; at
the default affine (1, 0) the random B5 is chaotic, its bf16 depth maps
differ from fp32 by 1.5% to 30% from seed to seed. For serving, each BatchNorm's running
statistics are then set from its own input in one eval forward of the
reference over calibration frames (the per-channel mean and the variance
averaged over the layer's channels), so each layer's output has about unit
variance, as a trained network's has; and ``conv_out``'s weight is scaled
so that the bins' logits have the standard deviation ``LOGIT_STD`` on those
frames. Without that a random model's bin distributions are flat on some
seeds, its depth maps barely depend on the image (a spread of 3 cm against
30 cm on other seeds), and no comparison can tell a lower precision from
the program's. The program and the reference load that one fp32 state dict; BN
folding, the casts and the kernels' weight layouts are the program's own.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the checkout
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "objcavit_tpu")  # top-level module names


def set_environment() -> None:
    """Before torch or numpy is imported: keep every compile cache inside
    the checkout, at fixed paths, so only a checkout's first run builds (the
    port's own kernel library builds into ``objcavit_torch/_build/`` there
    already); keep JAX out; and one CPU thread a math library. The runs are
    host-bound: idle CPU threads that spin after each operation take cycles
    from the thread that launches, on a host whose cores are shared, and on
    the H100 machine eight threads ran the stream 6-15% slower and spread
    the train step's rate wider (``PERF.md`` §2)."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"
    cache = BENCH_DIR / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(held_back: bool = False) -> dict:
    """``BENCHMARK.json``; with ``held_back``, its lists joined by those of
    ``held_back.json``: a cell proven correct on the card whose rate spreads
    too widely between runs for the bounds the benchmark may set, left out
    of the benchmark (``PERF.md`` §7). The tests and ``control.py`` still
    drive it; a later benchmark PR moves its entries over."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if held_back:
        for key, entries in load_json(BENCH_DIR / "held_back.json").items():
            bench[key] = bench[key] + entries
    return bench


def cell_files(workload: str, bench: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """-> (the workload entry, its configuration file, its traffic file, its
    limits) by the names in ``BENCHMARK.json``; KeyError for an unknown name."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
    return entry, config, traffic, limits


class Cell:
    """One run of one cell: its files, seed, device and the run's options."""

    def __init__(self, workload: str, config: dict, traffic: dict, limits: dict, seed: int,
                 device: str = "cuda"):
        self.workload = workload
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.seed = int(seed)
        self.device = device

    def generator(self, salt: int):
        """A generator on the cell's device, from the seed and ``salt``
        (0 weights, 1 inputs, 2 the train step's draws)."""
        import torch

        return torch.Generator(device=self.device).manual_seed((self.seed * 4 + salt) % 2**63)

    def rng(self, salt: int):
        import numpy as np

        return np.random.default_rng([self.seed % 2**63, salt])


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- weights

BN_WEIGHT, BN_BIAS = (0.4, 0.6), (0.9, 1.1)  # the ranges of the uniform draws


def fill_weights_(model, generator) -> None:
    """Every parameter of the reference ``model`` from ``generator`` in one
    draw (see the module note); BN running statistics at mean 0, var 1."""
    import torch
    import torch.nn as nn

    from h100bench.reference import model as ref

    targets = []  # (tensor, low, high)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            targets.append((m.weight, -bound, bound))
            if m.bias is not None:
                targets.append((m.bias, -bound, bound))
        elif isinstance(m, nn.BatchNorm2d):
            targets += [(m.weight, *BN_WEIGHT), (m.bias, *BN_BIAS)]
        elif isinstance(m, ref.MultiHeadAttention):
            e = m.in_proj_weight.shape[1]
            bound = math.sqrt(6.0 / (e + 3 * e))
            targets.append((m.in_proj_weight, -bound, bound))
        elif isinstance(m, ref.PatchTransformerEncoder):
            targets.append((m.positional_encodings, 0.0, 1.0))
    total = sum(t.numel() for t, _, _ in targets)
    with torch.no_grad():
        u = torch.rand(total, generator=generator, device=generator.device)
        offset = 0
        for t, lo, hi in targets:
            n = t.numel()
            t.copy_((lo + (hi - lo) * u[offset:offset + n]).view_as(t))
            offset += n
        for m in model.modules():
            if isinstance(m, ref.MultiHeadAttention):
                m.in_proj_bias.zero_()
                m.out_proj.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()


@contextlib.contextmanager
def exact_fp32():
    """TF32 off inside, the settings as they were outside."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def calibrate_batchnorm_(model, *inputs) -> None:
    """Set every BN's running statistics from its own input in one eval
    forward of ``inputs``: the per-channel mean, and the variance averaged
    over the layer's channels (a per-channel one would blow up channels
    that are near-constant on the frames)."""
    import torch
    import torch.nn as nn

    def set_stats(bn, args):
        x = args[0]
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.fill_(float(x.var((0, 2, 3), unbiased=False).mean()))

    handles = [m.register_forward_pre_hook(set_stats) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    try:
        with torch.no_grad(), exact_fp32():
            model.eval()(*inputs)
    finally:
        for h in handles:
            h.remove()


LOGIT_STD = 2.0
CALIBRATION_FRAMES = 2  # the seed's frames that the served BN statistics and logits are set on


def calibrate_logits_(model, *inputs) -> None:
    """Scale ``conv_out``'s weight so that the bins' logits on ``inputs``
    have the standard deviation ``LOGIT_STD``."""
    import torch

    head = model.objcavit if hasattr(model, "objcavit") else model.adaptive_bins_layer
    seen = {}
    handle = head.register_forward_hook(lambda m, a, out: seen.setdefault("out", out))
    try:
        with torch.no_grad(), exact_fp32():
            model.eval()(*inputs)
            _, feat, queries = seen["out"]
            conv = model.conv_out[0]
            logits = torch.einsum("bhwc,bkc->bhwk", feat, queries) @ conv.weight.flatten(1).t()
            conv.weight.mul_(LOGIT_STD / float(logits.std()))
    finally:
        handle.remove()


def reference_model(cell: Cell, device=None):
    """The plain fp32 reference with the cell's weights, on ``device``."""
    import torch

    from h100bench.reference import model as ref

    device = cell.device if device is None else device
    with torch.device("meta"):
        model = ref.build(cell.config["model"], cell.config["kwargs"])
    model = model.to_empty(device=device)
    fill_weights_(model, cell.generator(0))
    return model


def port_model(cell: Cell, state: dict, route: dict):
    """The program's model (``objcavit_torch.models``) with ``state`` loaded,
    on the cell's device, with the routes of ``route`` (the config's
    ``serve`` or ``train`` section), fp32 parameters."""
    import torch

    from objcavit_torch.models.adabins import AdaBins
    from objcavit_torch.models.graphbins import GraphBins

    cls = {"graphbins": GraphBins, "adabins": AdaBins}[cell.config["model"]]
    kwargs = dict(cell.config["kwargs"], attn_impl=route["attn_impl"],
                  encoder_impl=route["encoder_impl"])
    with torch.device("meta"):
        model = cls(**kwargs)
    model = model.to_empty(device=cell.device)
    model.load_state_dict(state, strict=True)
    return model


def dtype_of(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------- inputs

def make_frames(cell: Cell, n: int, h: int, w: int):
    """``n`` uint8 (H, W, 3) frames on the host, numpy: smooth random scenes
    (a 1/16-resolution field upsampled, plus fine texture), from the seed."""
    import torch
    import torch.nn.functional as F

    g = cell.generator(1)
    coarse = torch.rand((n, 3, max(h // 16, 2), max(w // 16, 2)), generator=g, device=cell.device)
    img = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    img = 0.85 * img + 0.15 * torch.rand((n, 3, h, w), generator=g, device=cell.device)
    frames = (img * 255.0).round().clamp(0, 255).to(torch.uint8)
    return frames.permute(0, 2, 3, 1).contiguous().cpu().numpy()


# ---------------------------------------------------------------- report

def check_report(checks: dict) -> tuple[bool, dict]:
    """``checks``: name -> (value, limit), each passing when value <= limit
    (NaN fails). -> (all passed, {name: {"value", "limit"}})."""
    out, ok = {}, True
    for name, (value, limit) in checks.items():
        passed = value is not None and math.isfinite(value) and value <= limit
        ok = ok and passed
        out[name] = {"value": value, "limit": limit}
    return ok, out


def print_checks(report: dict) -> None:
    for name, c in report.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
