"""The schedules and launch rules of the Hopper kernels 2, 3, 5 and 6, on the CPU.

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
Kernel 6 (``csrc/detect_head.cu``) hands its feature tile between a
producer and two consumer warpgroups on mbarriers; ``_simulate_detect`` is
a twin of that protocol (asynchronous products, waits by parity), which
finds the race of the hand-back before its repair and none after; the
card test's share-edge grids are checked here, on a copy of the kernel's
unit split (``utils/kernel_io.py``) that a test holds to the source's text.
"""

import collections
import random
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from objcavit_tpu.ops.pallas_bins import fused_conv_bins_depth_batched

from objcavit_torch.kernels import attention as kattn
from objcavit_torch.kernels import bins as kbins
from objcavit_torch.kernels import detect_head as kdetect
from objcavit_torch.kernels.build import CSRC_DIR
from objcavit_torch.utils.kernel_io import (
    detect_unit_count,
    detect_unit_shares,
    exact_fold_units,
    share_edge_grids,
)

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

    def arrive(self, n=1):
        self.arrivals += n
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


# ------------------------------------------------------------- kernel 6


def _simulate_detect(per_row, u0, u1, kc, stages, seed, protocol="repaired"):
    """Kernel 6's block protocol on units [u0, u1) (``per_row`` units a row
    tile, ``kc`` weight chunks a unit), each actor a generator stepped in a
    random order, every wait by parity alone (``_Bar``):

    * the producer: a row tile's features into the single A buffer when the
      tile changes (after waiting ``a_empty`` for the tile before), then the
      unit's weight chunks into the ring of ``stages`` (``full``/``empty``);
    * two consumer warpgroups on alternate units, ordered by the ``turn``
      barriers: each issues a unit's products chunk by chunk, hands the
      turn over, waits for its own products (``wgmma_wait<0>``) and hands
      back its stage and the feature tiles it is done with;
    * TMA landings, in any order, and the products' completions, each a
      separate event some random steps after its issue: an issued product
      reads A and its stage until it completes.

    ``protocol``: "repaired" (a warpgroup waits for a tile's load before
    handing the tile back), "parent" (tiles handed back unread), "no-turn"
    (the parent's, without the turn barriers). -> the faults seen: a wait
    that passed before its phase completed, a product that read another
    tile or chunk, a TMA issued onto a buffer that a product in flight still
    reads, or a hang."""
    rnd = random.Random(seed)
    p_done = rnd.choice([0.03, 0.1, 0.3])  # how slowly products complete
    full = [_Bar() for _ in range(stages)]
    empty = [_Bar(4) for _ in range(stages)]  # one warpgroup's four warps
    a_full, a_empty = _Bar(), _Bar(8)  # the eight consumer warps
    turn = [_Bar(4), _Bar(4)]
    r_first = u0 // per_row
    n_rows = (u1 - 1) // per_row - r_first + 1
    smem = {"a": None, "w": [None] * stages}
    writing = collections.Counter()  # buffers a TMA copy is writing: "a" or a stage
    reading = [[], []]  # each warpgroup's products in flight: the stage each reads
    landing, bad = [], []

    def wait(bar, phase, who):
        while not bar.parity_passes(phase & 1):
            yield
        if bar.n <= phase:
            bad.append(("early wait", who, phase))

    def tma(buf, what, bar):
        if any(buf == "a" or buf == s for group in reading for s in group):
            bad.append(("overwrite in flight", buf, what))
        writing[buf] += 1
        landing.append((buf, what, bar))

    def producer():
        cur = -1
        for u in range(u0, u1):
            t = u // per_row - r_first
            if t != cur:
                if cur >= 0:
                    yield from wait(a_empty, t - 1, "producer a_empty")
                tma("a", t, a_full)
                cur = t
            for k in range(kc):
                g = (u - u0) * kc + k
                yield from wait(empty[g % stages], g // stages - 1, "producer empty")
                tma(g % stages, g, full[g % stages])
                yield

    def consumer(wg):
        released, have, turns = 0, -1, 0

        def hand_back(upto):  # feature tiles before ``upto``
            nonlocal released, have
            while released < upto:
                if protocol == "repaired" and released > have:
                    yield from wait(a_full, released, f"wg{wg} a_full before hand-back")
                    have = released
                a_empty.arrive(4)
                released += 1
                yield

        for u in range(u0 + wg, u1, 2):
            t = u // per_row - r_first
            yield from hand_back(t)
            if u != u0 and protocol != "no-turn":
                yield from wait(turn[wg], turns, f"wg{wg} turn")
                turns += 1
            if t != have:
                yield from wait(a_full, t, f"wg{wg} a_full")
                have = t
            prev = None
            for k in range(kc):
                g = (u - u0) * kc + k
                s = g % stages
                yield from wait(full[s], g // stages, f"wg{wg} full")
                if smem["a"] != t or writing["a"] or smem["w"][s] != g or writing[s]:
                    bad.append(("read", wg, u, k))
                reading[wg].append(s)
                yield
                if k > 0:
                    while len(reading[wg]) > 1:  # wgmma_wait<1>
                        yield
                    empty[prev].arrive(4)
                prev = s
            if protocol != "no-turn":
                turn[1 - wg].arrive(4)
            while reading[wg]:  # wgmma_wait<0>
                yield
            empty[prev].arrive(4)
            yield from hand_back((u + 2) // per_row - r_first if u + 2 < u1 else n_rows)

    actors = [producer(), consumer(0), consumer(1)]
    for _ in range(4000 + 400 * (u1 - u0) * kc):  # a wait on the wrong phase can hang it
        if not (actors or landing):
            return bad
        x = rnd.random()
        if landing and (not actors or x < 0.25):
            buf, what, bar = landing.pop(rnd.randrange(len(landing)))
            if buf == "a":
                smem["a"] = what
            else:
                smem["w"][buf] = what
            writing[buf] -= 1
            bar.arrive()
            continue
        busy = [group for group in reading if group]
        if busy and rnd.random() < p_done:
            rnd.choice(busy).pop(0)  # a warpgroup's products complete in order
            continue
        actor = actors[rnd.randrange(len(actors))]
        try:
            next(actor)
        except StopIteration:
            actors.remove(actor)
    return bad + [("hang",)]


def _share_kinds(per_row: int, units: int, grid: int) -> set[tuple[int, int]]:
    """The block shares of a grid as (first unit's place in its row tile,
    units): the protocol depends on nothing else."""
    return {(u0 % per_row, u1 - u0) for u0, u1 in detect_unit_shares(units, grid)}


def test_kernel6_split_copy_follows_the_source():
    """``kernel_io.detect_unit_count`` and ``detect_unit_shares`` copy
    csrc/detect_head.cu's split; the source's lines for it are still the
    ones copied, so a change there fails here until the copy follows."""
    text = (CSRC_DIR / "detect_head.cu").read_text()
    for line in ("job.per_row = kNa * job.ntile + 1;",
                 "job.units = (m + block_rows - 1) / block_rows * job.per_row;",
                 "const int blocks = job.units < grid ? job.units : grid;",
                 "const int u0 = (int)((long long)job.units * blockIdx.x / gridDim.x);",
                 "const int u1 = (int)((long long)job.units * (blockIdx.x + 1) / gridDim.x);",
                 "job.ntile = ncp / kBN;"):
        assert line in text, line
    assert "constexpr int kNa = 3;" in text and "constexpr int kBN = 128;" in text
    assert (kdetect.N_ANCHORS, kdetect.COL_TILE) == (3, 128)
    assert detect_unit_count(8 * 4800, 256, 1280) == (300 * 31, 31)
    assert detect_unit_shares(10, 4) == [(0, 2), (2, 5), (5, 7), (7, 10)]


def test_kernel6_parent_protocol_races_at_a_share_ending_on_a_row_tile_first_unit():
    """The hand-back before the repair: a share whose last unit is the first
    of row tile T + 1. The warpgroup that ran the unit before it hands back
    T and T + 1 at once, 8 arrivals that complete a_empty's phase T alone,
    while the other warpgroup's products on tile T may still be in flight;
    the producer then loads T + 1 over them."""
    per_row, kc, stages = 31, 2, 4
    # each share's last unit opens a row tile: tile 1 or 2 of the block
    shares = [(0, per_row + 1), (per_row - 3, per_row + 1), (2 * per_row - 5, 3 * per_row + 1)]
    for u0, u1 in shares:
        found = [_simulate_detect(per_row, u0, u1, kc, stages, seed, "parent")
                 for seed in range(50)]
        kinds = {fault[0] for faults in found for fault in faults}
        assert kinds == {"overwrite in flight"}, (u0, u1, kinds)
        assert not any(_simulate_detect(per_row, u0, u1, kc, stages, seed) for seed in range(50))


def test_kernel6_twin_without_turns_sees_the_start_race():
    """Without the turn barriers, a share that starts at a row tile's last
    unit lets the second warpgroup hand tile 0 back unread and wait for
    tile 1 by parity while phase 0 is pending: the wait passes at once."""
    per_row, kc, stages = 4, 2, 4
    found = [_simulate_detect(per_row, per_row - 1, 3 * per_row, kc, stages, seed, "no-turn")
             for seed in range(20)]
    kinds = {fault[0] for faults in found for fault in faults}
    assert "early wait" in kinds and "read" in kinds


@pytest.mark.parametrize("per_row,rows", [(4, 75), (31, 12)], ids=["nc128", "nc1203"])
def test_kernel6_repaired_protocol_is_clean_on_every_grid(per_row, rows):
    """Every grid of 1-264 blocks, 20 seeds each: no early wait, no wrong
    read, no overwrite, no hang. Shares that start or end at any place in a
    row tile occur across the grids (one of each kind is simulated once)."""
    units = rows * per_row
    kinds = set().union(*(_share_kinds(per_row, units, grid) for grid in range(1, 265)))
    ends_on_first = [(s, n) for s, n in kinds if (s + n - 1) % per_row == 0 and n >= 3]
    starts_on_last = [(s, n) for s, n in kinds if s == per_row - 1 and n >= 2]
    assert ends_on_first and starts_on_last
    for start, n in sorted(kinds):
        for seed in range(20):
            assert _simulate_detect(per_row, start, start + n, 2, 4, seed) == [], (start, n, seed)


@pytest.mark.parametrize("kc,stages", [(4, 8), (8, 5), (16, 5)],
                         ids=["level0-cin256", "level1-cin512", "level2-cin1024"])
def test_kernel6_repaired_protocol_is_clean_on_the_levels_rings(kc, stages):
    """The weight ring as the levels at 1203 classes size it (Cin / 64
    chunks a unit, as many 16 KB stages as fit beside the feature tile), on
    shares that start at a row tile's last unit, end at its first, or both."""
    per_row = 31
    for u0, u1 in [(per_row - 1, 2 * per_row + 1), (per_row - 1, 3 * per_row),
                   (2, per_row + 1), (per_row - 1, per_row + 1)]:
        for seed in range(20):
            assert _simulate_detect(per_row, u0, u1, kc, stages, seed) == [], (u0, u1, seed)


@pytest.mark.parametrize("m,cin,ncp", [(8 * 4800, 256, 1280), (3 * 111, 256, 256),
                                       (5 * 77, 512, 1280), (8 * 300, 1024, 1280)],
                         ids=["nyu-level0", "small-nc130", "small-cin512", "nyu-level2"])
def test_kernel6_share_edge_grids_hold_both_edges(m, cin, ncp):
    """The card test's grids (``kernel_io.share_edge_grids``): in each, one
    share starts at a row tile's last unit and one ends at a row tile's
    first unit."""
    units, per_row = detect_unit_count(m, cin, ncp)
    assert per_row == 3 * ncp // 128 + 1
    grids = share_edge_grids(m, cin, ncp)
    assert grids and all(2 <= grid <= 264 for grid in grids)
    for grid in grids:
        shares = detect_unit_shares(units, grid)
        assert any(u0 % per_row == per_row - 1 and u1 - u0 >= 2 for u0, u1 in shares)
        assert any((u1 - 1) % per_row == 0 and u1 - u0 >= 3 for u0, u1 in shares)


def test_kernel6_wrapper_passes_the_grid(monkeypatch):
    """``fused_detect_head`` launches on the SM count, the test seam on the
    grid it is given; each counts its launch."""
    calls = []

    class FakeLibrary:
        def objcavit_detect_head(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kdetect, "load_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(
        cuda_stream=0))
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((3 * (5 + 130 + 32), 256), generator=gen)
    packed = kdetect.pack_detect_head(w, torch.zeros(w.shape[0]), 130, 32, torch.bfloat16)
    flat = torch.zeros((3, 111, 256), dtype=torch.bfloat16)
    before = kdetect.fused_detect_head.launches
    kdetect._launch(flat, packed, 7)
    assert calls[0][10:17] == (333, 256, 130, 256, 32, 128, 7)
    assert kdetect.fused_detect_head.launches == before + 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        kdetect._fused_detect_head_on_grid(flat, packed, 7)


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
     (4, 512, 512, (1, 4)), (4, 513, 513, None), (16, 64, 64, (1, 1)), (32, 600, 40, None)],
    ids=["flagship", "train", "sq300-sk77", "s1200", "one-query", "many-heads", "sk512",
         "sk513", "one-tile", "sq600-sk40"])
def test_kernel5_fwd_plan(bh, sq, sk, want):
    assert kattn.fwd_plan(bh, sq, sk, H100_SMS) == want


def test_kernel5_fwd_plan_caps_the_key_groups():
    """A block of one m-tile has warps for 16 key groups and 8 key tiles at
    512 keys: the plan takes MAX_KEY_GROUPS (the C entry's kMaxKeyGroups)."""
    assert kattn.MAX_KEY_GROUPS == 4
    assert kattn.fwd_plan(1000, 16, 512, H100_SMS) == (1, 4)
    assert kattn.fwd_plan(132, 16, 300, H100_SMS) == (1, 4)


# blocks of the long forward an H100 SM holds at once, by warpgroups a
# block (objcavit_attention_long_fwd_blocks on the card: 122 registers a
# thread, so four blocks of one warpgroup, two of two, one of three)
H100_LONG_FWD_BLOCKS = {1: 4, 2: 2, 3: 1}
# (B * H, Sq, Sk) of the long routes: do_final_upscale served (1200 tokens
# against up to 1000 slots, both ways) and trained (884), a short key side
LONG_SHAPES = [(32, 1200, 1200), (32, 1200, 1000), (32, 1000, 1200), (32, 1000, 1000),
               (32, 884, 884), (32, 600, 40)]


@pytest.mark.parametrize("bh,sq,sk,want", [(32, 1200, 1200, 2), (32, 1200, 1000, 2),
                                           (32, 1000, 1200, 1), (32, 1000, 1000, 1),
                                           (32, 884, 884, 1), (32, 600, 40, 1), (8, 600, 600, 3),
                                           (4, 40, 513, 3), (256, 884, 884, 1)])
def test_kernel5_long_fwd_plan(bh, sq, sk, want):
    """At the served S 1200 (608 blocks of 64 rows) two key groups a block:
    three waves of two blocks an SM, each ceil(19 / 2) tiles long, against
    two of four one-group blocks over all 19 (the H100 read 0.0436 and
    0.0446 ms; three groups ran slower still). One group where the blocks
    fill the card in one wave (S 884's 448, 1000 x 1200's 512) or a head
    has one key tile; three where a few heads leave most SMs idle."""
    assert kattn.long_fwd_plan(bh, sq, sk, H100_SMS, H100_LONG_FWD_BLOCKS) == want


@pytest.mark.parametrize("bh,sq,sk", LONG_SHAPES)
def test_kernel5_long_fwd_plan_covers_every_row_and_key_tile_once(bh, sq, sk):
    """The plan's key groups take every key tile once, group 0 from tile 0
    and none longer than ceil(n / G); its count is the cheapest of 1..3 (its
    waves of blocks times its longest group's tiles times the warpgroups an
    SM holds, at least LONG_SATURATING_WGS), the fewest of equal costs; and
    its first wave gives every one of the card's 132 SMs a block."""
    groups = kattn.long_fwd_plan(bh, sq, sk, H100_SMS, H100_LONG_FWD_BLOCKS)
    n_kt = -(-sk // kattn.KEY_TILE)
    counts = range(1, min(kattn.MAX_LONG_GROUPS, n_kt) + 1)
    assert groups in counts
    tiles = kattn.key_group_tiles(n_kt, groups)
    assert [t for r in tiles for t in r] == list(range(n_kt))
    assert all(len(r) >= 1 for r in tiles) and max(len(r) for r in tiles) == -(-n_kt // groups)
    blocks = -(-sq // kattn.KEY_TILE) * bh

    def cost(g):
        per_sm = H100_LONG_FWD_BLOCKS[g]
        waves = -(-blocks // (H100_SMS * per_sm))
        longest = max(len(r) for r in kattn.key_group_tiles(n_kt, g))
        return waves * longest * max(per_sm * g, kattn.LONG_SATURATING_WGS)

    assert groups == min(counts, key=lambda g: (cost(g), g))
    assert min(blocks, H100_SMS * H100_LONG_FWD_BLOCKS[groups]) >= H100_SMS


def test_kernel5_key_groups_match_the_resident_forward():
    """key_group_tiles is the C kernels' group_first_tile: 5 tiles over 3
    groups, 8 over 4 (the resident forward at 512 keys), 19 over 3 (the
    long forward at S 1200)."""
    assert [list(r) for r in kattn.key_group_tiles(5, 3)] == [[0, 1], [2, 3], [4]]
    assert [len(r) for r in kattn.key_group_tiles(8, 4)] == [2, 2, 2, 2]
    assert [len(r) for r in kattn.key_group_tiles(19, 3)] == [7, 6, 6]


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
