"""The schedules and launch rules of the Hopper kernels 2, 3 and 5, on the CPU.

Kernel 2 (``csrc/bins_depth.cu``) is a persistent grid: units of (image,
64-pixel tile), image-major, a contiguous share of them a block, and a
producer that loads W and the centres when the image changes.
``unit_shares`` and ``producer_loads`` below are copies of that schedule
as the kernel computes it in C (they are not the kernel's own code): a NumPy
walk of them checks that every (image, pixel) is covered exactly once and
that W is loaded once per image change (once per block for a weight stride
of 0). Its ring plan is ``kernels/bins.py::ring_plan``, which the wrapper
passes to the C entry point, and a NumPy twin of its fold (no max
subtracted, the bias in the exponent, the exact fold for a unit with a row
outside the fast fold's range) is held against the JAX package's Pallas
kernel in interpret mode. Kernel 5's forward writes its residual only
where a backward may read it (``kernels/attention.py::residual_needed``),
and ``fwd_plan`` picks its launch plan, which the wrapper passes in.
"""

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from objcavit_tpu.ops.pallas_bins import fused_conv_bins_depth_batched

from objcavit_torch.kernels import attention as kattn
from objcavit_torch.kernels import bins as kbins
from objcavit_torch.utils.kernel_io import exact_fold_units

H100_SMS = 132
# the fast fold's range of a row's sum of e (csrc/bins_depth.cu kSumLo, kSumHi)
SUM_LO, SUM_HI = 2.0 ** -16, 2.0 ** 40


def unit_shares(b: int, s: int, grid: int) -> list[tuple[int, int]]:
    """A copy of the kernel's schedule (csrc/bins_depth.cu, the block's
    [u0, u1)): units are (image, tile of 64 pixels), image-major; block i of
    min(grid, units) takes units [u0, u1), a contiguous, equal share. Unit u
    covers pixels [64 t, 64 t + 64) of image u // tiles (t = u % tiles),
    clipped to S."""
    units = b * -(-s // kbins.UNIT_PIXELS)
    blocks = min(units, grid)
    return [(units * i // blocks, units * (i + 1) // blocks) for i in range(blocks)]


def producer_loads(b: int, s: int, u0: int, u1: int, shared_w: bool) -> tuple[int, int]:
    """A copy of the producer's rule: (W loads, centre loads) of the block
    with units [u0, u1): it loads an image's centres when the image changes,
    and W when the weight changes (every image, or once with a weight stride
    of 0)."""
    tiles = -(-s // kbins.UNIT_PIXELS)
    cur_b = cur_w = -1
    w_loads = c_loads = 0
    for u in range(u0, u1):
        img = u // tiles
        if img != cur_b:
            wid = 0 if shared_w else img
            c_loads += 1
            w_loads += wid != cur_w
            cur_b, cur_w = img, wid
    return w_loads, c_loads


def _covered(b: int, s: int, grid: int) -> np.ndarray:
    """How many times the schedule computes and stores each (image, pixel)."""
    tiles = -(-s // kbins.UNIT_PIXELS)
    count = np.zeros((b, s), dtype=np.int64)
    for u0, u1 in unit_shares(b, s, grid):
        for u in range(u0, u1):
            img, t = divmod(u, tiles)
            count[img, t * kbins.UNIT_PIXELS:(t + 1) * kbins.UNIT_PIXELS] += 1
    return count


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("s", [1, 63, 1000, 240 * 320 + 13], ids=["s1", "s63", "s1000", "s76813"])
@pytest.mark.parametrize("grid", [1, 7, H100_SMS, 5000])
def test_kernel2_schedule_covers_every_pixel_once(b, s, grid):
    assert (_covered(b, s, grid) == 1).all()
    shares = unit_shares(b, s, grid)
    units = b * -(-s // kbins.UNIT_PIXELS)
    assert len(shares) == min(units, grid)
    assert shares[0][0] == 0 and shares[-1][1] == units
    assert all(prev[1] == nxt[0] for prev, nxt in zip(shares, shares[1:]))
    sizes = [u1 - u0 for u0, u1 in shares]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("b,s", [(1, 1000), (3, 4097), (8, 240 * 320), (8, 240 * 320 + 13)])
@pytest.mark.parametrize("shared_w", [False, True], ids=["per-image-W", "shared-W"])
def test_kernel2_producer_loads_w_once_per_image_change(b, s, shared_w):
    """The producer loads the centres once per image a block meets, and W
    as often (per-image W) or once per block (a weight stride of 0)."""
    tiles = -(-s // kbins.UNIT_PIXELS)
    for u0, u1 in unit_shares(b, s, H100_SMS):
        images = (u1 - 1) // tiles - u0 // tiles + 1
        w_loads, c_loads = producer_loads(b, s, u0, u1, shared_w)
        assert c_loads == images
        assert w_loads == (1 if shared_w else images)


def test_kernel2_flagship_block_meets_at_most_two_images():
    """At the flagship's (8, 76,800) a share (~4,650 pixels) is far below an
    image, so a block reloads W at most once."""
    b, s = 8, 240 * 320
    loads = [producer_loads(b, s, u0, u1, False)[0]
             for u0, u1 in unit_shares(b, s, H100_SMS)]
    assert max(loads) == 2 and min(loads) == 1


@pytest.mark.parametrize("c", range(16, 257, 16))
def test_kernel2_ring_holds_a_stage_per_consumer(c, monkeypatch):
    """The ring plan fits shared memory beside W, holds a stage per
    consumer, and is what the wrapper passes to the C entry point."""
    stages, consumers = kbins.ring_plan(c)
    assert 2 <= stages <= 8 and 1 <= consumers <= min(kbins.CONSUMERS, stages)
    assert (stages, consumers) == {128: (8, 3), 256: (2, 2)}.get(c, (stages, consumers))
    stage = -(-c // 64) * kbins.UNIT_PIXELS * 64 * 2
    assert kbins._SMEM_HEAD + c * kbins.N_BINS * 2 + stages * stage <= kbins._SMEM_MAX
    calls = []

    class FakeLibrary:
        def objcavit_conv_bins_depth_batched(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kbins, "load_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(
        cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None:
                        types.SimpleNamespace(multi_processor_count=H100_SMS))
    x = torch.zeros((2, 3, 5, c), dtype=torch.bfloat16)
    kbins._launch(x, torch.zeros((2, c, 256), dtype=torch.bfloat16), torch.zeros(256),
                  torch.zeros((2, 256)))
    (args,) = calls
    assert args[5:12] == (2, 15, c, c * 256, H100_SMS, stages, consumers)


class _Bar:
    """An mbarrier: completed phases n; arrivals count toward the current
    phase, which completes after `count` of them."""

    def __init__(self, count=1):
        self.n, self.arrivals, self.count = 0, 0, count

    def arrive(self):
        self.arrivals += 1
        while self.arrivals >= (self.n + 1) * self.count:
            self.n += 1

    def parity_passes(self, parity):
        # mbarrier.try_wait.parity: true once the phase of that parity is
        # not the current one
        return self.n % 2 != parity


def _simulate(tiles, units, stages, consumers, lockstep, seed):
    """Kernel 2's block protocol, each actor a generator stepped in a random
    order: the producer (image loads on img_full/img_empty, x tiles on
    full/empty), TMA landings some steps later, and the consumers, whose
    waits pass by parity alone. -> the violations seen: a wait that passed
    before its phase completed, a unit that read another's x or W, or a
    hang."""
    rng = np.random.default_rng(seed)
    full = [_Bar() for _ in range(stages)]
    empty = [_Bar() for _ in range(stages)]
    img_full, img_empty = _Bar(), _Bar(consumers)
    landing, smem = [], {"w": None, "x": [None] * stages}
    bad = []

    def wait(bar, phase):  # a consumer's parity wait for `phase`
        while not bar.parity_passes(phase & 1):
            yield
        if bar.n <= phase:
            bad.append(("early wait", phase))

    def producer():
        cur = -1
        for u in range(units):
            img = u // tiles
            if img != cur:
                while cur >= 0 and img_empty.n <= cur:
                    yield
                landing.append(("w", img, img_full))
                cur = img
            while empty[u % stages].n < u // stages:
                yield
            landing.append(("x", u, full[u % stages]))
            yield

    def consumer(k):
        released, have = 0, -1
        for u in list(range(k, units, consumers)) + [None]:
            e = units // tiles if u is None else u // tiles
            for r in range(released, e):
                if lockstep and r > have:
                    yield from wait(img_full, r)
                    have = r
                img_empty.arrive()
                released = r + 1
                yield
            if u is None:
                return
            if e != have:
                yield from wait(img_full, e)
                have = e
            yield from wait(full[u % stages], u // stages)
            yield
            if smem["x"][u % stages] != u or smem["w"] != e:
                bad.append(("read", u))
            empty[u % stages].arrive()

    actors = [producer()] + [consumer(k) for k in range(consumers)]
    for _ in range(200_000):  # a wait on the wrong phase can hang it
        if not (actors or landing):
            return bad
        if landing and (not actors or rng.random() < 0.3):
            kind, what, bar = landing.pop(0)
            if kind == "w":
                smem["w"] = what
            else:
                smem["x"][what % stages] = what
            bar.arrive()
            continue
        actor = actors[rng.integers(len(actors))]
        try:
            next(actor)
        except StopIteration:
            actors.remove(actor)
    return bad + [("hang",)]


@pytest.mark.parametrize("tiles", [1, 2, 5, 1200])
@pytest.mark.parametrize("c", [128, 240, 256])
def test_kernel2_protocol_waits_never_pass_early(tiles, c):
    """The ring plan and the consumers' lockstep image waits (a consumer
    waits for an image's load before handing it back, also an image it
    takes no unit of) under random interleavings, images of 1-1200 units."""
    stages, consumers = kbins.ring_plan(c)
    for seed in range(20):
        assert _simulate(tiles, min(3 * tiles + 7, 50), stages, consumers, True, seed) == []


def test_kernel2_protocol_twin_sees_the_races_it_guards_against():
    """Without the lockstep waits, or with three consumers on two stages,
    the same simulation finds early waits and wrong reads."""
    naive = [_simulate(1, 20, 8, 3, False, seed) for seed in range(20)]
    shallow = [_simulate(1200, 50, 2, 3, True, seed) for seed in range(20)]
    assert any(naive) and any(shallow)


def _fold_twin(x, w, bias, centers):
    """kernel 2's arithmetic on its schedule, in NumPy fp32: per unit, the
    logits' exps with no max subtracted (x W log2 e + bias log2 e into 2^t);
    if a row's sum of e leaves [2^-16, 2^40], the whole unit is folded again
    with each row's max subtracted. -> (depth (B, S), units folded exactly)."""
    b, s, _ = x.shape
    tiles = -(-s // kbins.UNIT_PIXELS)
    log2e = np.float32(1.4426950408889634)
    depth = np.zeros((b, s), np.float32)
    exact = 0
    for u0, u1 in unit_shares(b, s, H100_SMS):
        for u in range(u0, u1):
            img, t = divmod(u, tiles)
            rows = slice(t * kbins.UNIT_PIXELS, min((t + 1) * kbins.UNIT_PIXELS, s))
            prod = x[img, rows] @ w[img]
            e = np.exp2(prod * log2e + bias * log2e)
            se = e.sum(-1)
            if not ((se >= SUM_LO) & (se <= SUM_HI)).all():
                exact += 1
                logits = prod + bias
                e = np.exp(logits - logits.max(-1, keepdims=True))
                se = e.sum(-1)
            depth[img, rows] = (e @ centers[img]) / se
    return depth, exact


@pytest.mark.parametrize("bias_shift,want_exact", [(0.0, False), (40.0, True), (-30.0, True)],
                         ids=["fast", "large-logits", "small-logits"])
def test_kernel2_fold_twin_matches_pallas(bias_shift, want_exact):
    """The fast fold and its exact fallback against the Pallas kernel in
    interpret mode, at the tolerance of tests/test_pallas_bins.py."""
    rng = np.random.default_rng(11)
    b, h, w, c = 2, 8, 40, 32
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kern = (0.3 * rng.standard_normal((b, c, 256))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256) + bias_shift).astype(np.float32)
    centers = np.sort(rng.uniform(0.001, 10, (b, 256))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = fused_conv_bins_depth_batched(*map(jnp.asarray, (x, kern, bias, centers)))
    got, exact = _fold_twin(x.reshape(b, h * w, c), kern, bias, centers)
    assert (exact > 0) == want_exact
    np.testing.assert_allclose(got.reshape(b, h, w, 1), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("bias_shift,s", [(0.0, 320), (40.0, 320), (-30.0, 320), (0.0, 300),
                                          (40.0, 300)],
                         ids=["fast", "large-logits", "small-logits", "fast-s300",
                              "large-logits-s300"])
def test_kernel2_exact_fold_units_follow_the_fold_twin(bias_shift, s):
    """kernel_io.exact_fold_units, which chip_smoke.py reads on the served
    forwards, counts the units the fold twin folds exactly: none at the
    model's logits, all of them with every logit shifted past the range."""
    rng = np.random.default_rng(11)
    b, c = 2, 32
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    kern = (0.3 * rng.standard_normal((b, c, 256))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256) + bias_shift).astype(np.float32)
    centers = np.sort(rng.uniform(0.001, 10, (b, 256))).astype(np.float32)
    _, want = _fold_twin(x, kern, bias, centers)
    exact, units = exact_fold_units(torch.from_numpy(x).view(b, 1, s, c), torch.from_numpy(kern),
                                    torch.from_numpy(bias))
    assert units == b * -(-s // kbins.UNIT_PIXELS)
    assert exact == want == (0 if bias_shift == 0 else units)


@pytest.mark.parametrize("c", [16, 48, 128, 256])
@pytest.mark.parametrize("shared_w", [False, True], ids=["per-image-W", "shared-W"])
def test_kernel2_contract_accepts_the_models_widths(c, shared_w):
    x = torch.zeros(2, 3, 5, c, dtype=torch.bfloat16)
    w = torch.zeros(2, c, 256, dtype=torch.bfloat16)
    if shared_w:
        w = w[:1].expand(2, c, 256)
    kbins.check_bins_inputs(x, w, torch.zeros(256), torch.zeros(2, 256))


def test_kernel2_contract_rejects_misaligned_centers_and_other_w_strides():
    x = torch.zeros(2, 3, 5, 16, dtype=torch.bfloat16)
    w = torch.zeros(2, 16, 256, dtype=torch.bfloat16)
    centers = torch.zeros(2 * 256 + 1)[1:].view(2, 256)  # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        kbins.check_bins_inputs(x, w, torch.zeros(256), centers)
    wide = torch.zeros(2, 16, 512, dtype=torch.bfloat16)[..., :256]
    with pytest.raises(ValueError, match="batch stride"):
        kbins.check_bins_inputs(x, wide, torch.zeros(256), torch.zeros(2, 256))
    padded = torch.zeros(3, 16, 256, dtype=torch.bfloat16)[::2]  # batch stride 2 C K
    with pytest.raises(ValueError, match="batch stride"):
        kbins.check_bins_inputs(x, padded, torch.zeros(256), torch.zeros(2, 256))


# ------------------------------------------------------------- kernel 5


def _qkv(requires_grad: bool):
    gen = torch.Generator().manual_seed(3)
    return [torch.randn((2, 6, 4, 32), generator=gen).to(torch.bfloat16)
            .requires_grad_(requires_grad) for _ in range(3)]


def test_kernel5_residual_needed_follows_autograd():
    q, k, v = _qkv(True)
    assert kattn.residual_needed(q, k, v)
    with torch.no_grad():
        assert not kattn.residual_needed(q, k, v)
    with torch.inference_mode():
        assert not kattn.residual_needed(q, k, v)
    assert not kattn.residual_needed(*_qkv(False))
    with torch.enable_grad():
        assert kattn.residual_needed(q.detach(), k.detach(), v)


@pytest.mark.parametrize("mode", ["no_grad", "inference", "no_input_requires_grad", "train"])
def test_kernel5_residual_skipped_where_no_backward_reads_it(monkeypatch, mode):
    """fused_mha asks the forward for a residual only where autograd may run
    the backward; the forward's output does not depend on it."""
    asked = []
    original = kattn.fused_mha_fwd

    def recording(q, k, v, bias=None, residual=True):
        asked.append(residual)
        return original(q, k, v, bias, residual)

    monkeypatch.setattr(kattn, "fused_mha_fwd", recording)
    q, k, v = _qkv(mode == "train" or mode != "no_input_requires_grad")
    mask = torch.tensor([[False] * 5 + [True], [False] * 6])
    if mode == "no_grad":
        with torch.no_grad():
            out = kattn.fused_mha(q, k, v, mask)
    elif mode == "inference":
        with torch.inference_mode():
            out = kattn.fused_mha(q, k, v, mask)
    else:
        out = kattn.fused_mha(q, k, v, mask)
    assert asked == [mode == "train"]
    want = kattn.mha_fused_plain(q.detach(), k.detach(), v.detach(), kattn.mask_bias(mask))
    assert torch.equal(out.detach(), want)
    if mode == "train":
        out.float().sum().backward()
        assert all(t.grad is not None for t in (q, k, v))


def test_kernel5_forward_without_residual_returns_none_on_the_cpu():
    q, k, v = _qkv(False)
    out, stats = kattn.fused_mha_fwd(q, k, v, None, residual=False)
    assert stats is None and torch.equal(out, kattn.mha_fused_plain(q, k, v))


@pytest.mark.parametrize(
    "bh,sq,sk,want",
    [(32, 300, 300, (5, 3)), (32, 221, 221, (4, 4)), (32, 300, 77, (5, 2)),
     (8, 1200, 1200, None), (2, 1, 5, (1, 1)), (256, 300, 300, (8, 2)),
     (4, 512, 512, (1, 4)), (4, 513, 513, None), (16, 64, 64, (1, 1))],
    ids=["flagship", "train", "sq300-sk77", "s1200", "one-query", "many-heads", "sk512",
         "sk513", "one-tile"])
def test_kernel5_fwd_plan(bh, sq, sk, want):
    assert kattn.fwd_plan(bh, sq, sk, H100_SMS) == want


def test_kernel5_fwd_plan_caps_the_key_groups():
    """A block of one m-tile has warps for 16 key groups and 8 key tiles at
    512 keys: the plan takes MAX_KEY_GROUPS (the C entry's kMaxKeyGroups)."""
    assert kattn.MAX_KEY_GROUPS == 4
    assert kattn.fwd_plan(1000, 16, 512, H100_SMS) == (1, 4)
    assert kattn.fwd_plan(132, 16, 300, H100_SMS) == (1, 4)


@pytest.mark.parametrize("bh", [1, 8, 32, 33, 132, 300])
@pytest.mark.parametrize("s", [1, 77, 221, 300, 512])
def test_kernel5_fwd_plan_fills_the_card_once(bh, s):
    """At most 16 warps a block, at most 4 key groups and never more than the
    key tiles; while the heads leave SMs over, the blocks fit the card."""
    rows, groups = kattn.fwd_plan(bh, s, s, H100_SMS)
    n_kt = -(-s // kattn.KEY_TILE)
    assert 1 <= rows <= 8 and 1 <= groups <= min(4, n_kt) and rows * groups <= 16
    blocks = bh * -(-s // (16 * rows))
    if bh <= H100_SMS and rows < 8:
        assert blocks <= H100_SMS
