"""Kernel 5's backward, or forward, against an earlier build of it and SDPA's, in turns on one card.

    python -m objcavit_torch.utils.attention_ab --old OLD.cu [--alt ALT.cu ...] [--rounds 8]
    python -m objcavit_torch.utils.attention_ab --fwd --old OLD.cu [--rounds 8]
    python -m objcavit_torch.utils.attention_ab --long --old OLD.cu [--rounds 8]

``OLD.cu`` is an earlier ``csrc/attention.cu`` with the two-kernel
backward's C interface (``git show 7e28ee7:objcavit_torch/csrc/attention.cu``):
``objcavit_attention_bwd(q, k, v, bias, g, stats, dq, dk, dv, drow, strides,
b, h, s_q, s_k, scale, stream)``. Each ``ALT.cu`` is a variant of the
current source, with its C interface, timed beside them (a variant's
errors are printed, not enforced, so a variant may leave work out to time
the rest). Each source is
compiled alone into ``objcavit_torch/_build/ab/``.

At the flagship's served self-attention (8, 300, 4, 32) and the train
step's (8, 221, 4, 32), with the served objects' masks, q, k and v read in
place from one in_proj output: the current backward (``fused_mha_bwd``) and
the old one are held against the plain version (chip_smoke.py's tolerance),
then each is timed as CUDA-graph replays of ``CALLS`` calls, in turns (the
order reversed every round), beside SDPA's backward, which is SDPA's forward
plus backward less its forward (autograd runs a backward on its forward's
stream, so a captured backward needs its forward in the same graph). Prints
the card's name and power limit, then one JSON line per shape: medians and
spreads in ms per call, the current route, how many of its clusters the
card holds at once, and the bound (bytes once over
3.35 TB/s, or the five products over 989 TFLOP/s).

With ``--fwd`` it times the forward instead, at the same two shapes and
masks: the current forward as a served call (no residual: what
``fused_mha`` launches under ``torch.no_grad()``) and as a training call
(the residual written), the old source's forward (the interface of
``git show 43c3e27:objcavit_torch/csrc/attention.cu``, the current one less
the plan arguments: ``objcavit_attention_fwd(q, k, v, bias, o, stats,
strides, b, h, s_q, s_k, scale, stream)``; it always writes the residual)
and SDPA's forward with the same additive mask. Each is first held against the plain
forward, and the current residual must give the plain backward through
``fused_mha_bwd``. The forward's accuracy against an fp64 reference is
printed for each count of key groups at the plan's rows, and whether one
key group gives the old forward's bits (``fwd_precision``). The bound is q,
k, v and the bias read and o written once (the residual too for the
training call) over 3.35 TB/s, or the two products over 989 TFLOP/s.

With ``--long`` it takes the long routes (Sq or Sk above 512) at
``LONG_SHAPES``: the served S 1200 without a mask, 1200 queries against
1000 object slots with the served objects' masks, and the train step's S
884. ``OLD.cu`` is then an earlier source with the current C interface
(``git show 938326d:objcavit_torch/csrc/attention.cu``: the streaming
forward and two-kernel backward that these routes replaced). The current forward (served and
training calls) and backward, and the old ones (each backward on its own
forward's residual), are held against the plain versions, then timed in
turns beside SDPA's forward and backward; each row also gives the bound,
the exps (one a score for each time a route computes P: 1 forward, 3 in
either backward) and their time on the SFU alone (``bins_ab.sfu_ms``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from objcavit_torch.kernels import attention as kattn
from objcavit_torch.kernels import build
from objcavit_torch.utils.bins_ab import max_sm_mhz, sfu_ms
from objcavit_torch.utils.detect_head_ab import CALLS, captured, replay_ms

HEADS, HEAD_DIM = 4, kattn.HEAD_DIM
SHAPES = [("flagship 480x640", 8, 300, 300), ("train 416x544", 8, 221, 221)]
# (label, B, Sq, Sk, mask) of the long routes under do_final_upscale
LONG_SHAPES = [("served S 1200", 8, 1200, 1200, "none"),
               ("served 1200x1000", 8, 1200, 1000, "served"),
               ("train S 884", 8, 884, 884, "none")]
SERVED_VALID = [3, 17, 40, 1, 120, 300, 64, 8]  # valid object slots per served image
RTOL, ATOL_PER_MAX = 2.0 ** -7, 1e-4  # chip_smoke.py's ATTN_RTOL, ATTN_ATOL_PER_MAX
HBM_BYTES_PER_MS, BF16_PER_MS = 3.35e12 / 1e3, 989e12 / 1e3


def attention_inputs(gen: torch.Generator, b: int, sq: int, sk: int, mask_kind: str):
    """bf16 q, k, v, g (B, S, 4, 32) on the card and a mask. A self-attention
    (Sq = Sk) reads q, k, v in place from one chunked in_proj output, as the
    model does. Masks: 'served', image i's first SERVED_VALID[i] keys valid;
    'full', image 0 fully masked and the others served; 'none'."""
    e = HEADS * HEAD_DIM
    if sq == sk:
        qkv = torch.randn((b, sq, 3 * e), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.reshape(b, sq, HEADS, HEAD_DIM) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn((b, s, HEADS, HEAD_DIM), generator=gen,
                               device="cuda").to(torch.bfloat16) for s in (sq, sk, sk))
    g = torch.randn((b, sq, HEADS, HEAD_DIM), generator=gen, device="cuda").to(torch.bfloat16)
    mask = None
    if mask_kind != "none":
        counts = torch.tensor([SERVED_VALID[i % len(SERVED_VALID)] for i in range(b)],
                              device="cuda").clamp(max=sk)
        mask = torch.arange(sk, device="cuda")[None] >= counts[:, None]
        if mask_kind == "full":
            mask[0] = True
    return q, k, v, g, mask


def bwd_cost(b: int, h: int, sq: int, sk: int) -> tuple[int, int]:
    """(bytes, bf16 operations) of one backward: q, k, v, g, the bias and the
    residual (each row's max and log-sum, fp32) read once, dq, dk, dv written
    once (bf16 rows of H * D: q, g, dq are Sq rows, k, v, dk, dv Sk rows);
    the five products (scores, g v^T, dv, dq, dk)."""
    row = 2 * b * h * HEAD_DIM
    nbytes = row * (3 * sq + 4 * sk) + 4 * b * sk + 2 * 4 * b * h * sq
    return nbytes, 5 * 2 * b * h * sq * sk * HEAD_DIM


def bwd_bound(b: int, h: int, sq: int, sk: int) -> dict:
    nbytes, ops = bwd_cost(b, h, sq, sk)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / BF16_PER_MS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def fwd_bound(b: int, h: int, sq: int, sk: int, residual: bool) -> dict:
    """q, k, v, the bias read and o written once (and the residual, two fp32
    values a row, where it is written) over the memory rate, or the two
    products over the bf16 peak."""
    row = 2 * b * h * HEAD_DIM
    nbytes = row * (2 * sq + 2 * sk) + 4 * b * sk + (2 * 4 * b * h * sq if residual else 0)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, 2 * 2 * b * h * sq * sk * HEAD_DIM / BF16_PER_MS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def load_entry(source: Path, name: str, argtypes: tuple, entry: str = "objcavit_attention_bwd"):
    """Compile ``source`` alone and bind its ``entry``."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libattention_{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-shared", "-o",
           str(lib_path), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib_path)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def old_fwd(fn, q, k, v, bias, plan=None, residual=True):
    """An earlier forward, called as its wrapper called it, with a residual
    of two rows unless ``residual`` is False; a variant of the current source
    with ``plan`` (its plan arguments). -> (o, the residual or None)."""
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    stats = (torch.empty((2, b * h, sq), dtype=torch.float32, device=q.device) if residual
             else None)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            o.data_ptr(), None if stats is None else stats.data_ptr(), strides, b, h, sq,
            k.shape[1], 1.0 / math.sqrt(d), *(() if plan is None else plan),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("old objcavit_attention_fwd", rc)
    return o, stats


def fwd_precision(q, k, v, bias, rows: int, old) -> dict:
    """The forward's bf16 output against the fp64 softmax attention, for
    each count of key groups its C entry takes beside the plan's ``rows``
    (called with that plan directly) and for the plain fp32 version: the
    share of outputs that are not the correctly rounded bf16 of the fp64
    result, and the mean error in units of the bf16 ulp of that result.
    Also whether one key group, the first port's summation order, gives the
    old source's output bit for bit."""
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
                      / math.sqrt(q.shape[-1]) + bias.double()[:, None, None, :], -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", w, v.double())
    ref_bf = ref.to(torch.bfloat16)
    ulp = torch.exp2(torch.floor(torch.log2(ref_bf.double().abs().clamp_min(1e-30))) - 7)

    def stats(out):
        return {"not_rounded_fp64": float((out != ref_bf).double().mean()),
                "mean_err_ulp": float(((out.double() - ref).abs() / ulp).mean())}

    entry = getattr(build.load_library(), "objcavit_attention_fwd")
    n_kt = -(-k.shape[1] // kattn.KEY_TILE)
    out, one = {}, None
    for groups in range(1, min(kattn.MAX_KEY_GROUPS, 16 // rows, n_kt) + 1):
        got = old_fwd(entry, q, k, v, bias, (rows, groups))[0]
        one = got if groups == 1 else one
        out[f"key_groups_{groups}"] = stats(got)
    out["plain_fp32"] = stats(kattn.mha_fused_plain(q, k, v, bias))
    out["one_group_equals_old"] = torch.equal(one, old_fwd(old, q, k, v, bias)[0])
    return out


def run_fwd(old, alts: dict, rounds: int, smi: str) -> None:
    """The ``--fwd`` comparison (see the module's note); ``alts`` are
    variants' forwards, timed with their errors printed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, sq, sk in SHAPES:
        q, k, v, g, mask = attention_inputs(gen, b, sq, sk, "served")
        bias = kattn.mask_bias(mask)
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        plan = kattn.fwd_plan(b * HEADS, sq, sk, n_sm) or (0, 0)
        want = kattn.mha_fused_plain(q, k, v, bias)
        served, none = kattn.fused_mha_fwd(q, k, v, bias, residual=False)
        trained, stats = kattn.fused_mha_fwd(q, k, v, bias)
        errs = {"served": errors([served], [want]), "train": errors([trained], [want]),
                "old": errors([old_fwd(old, q, k, v, bias)[0]], [want]),
                **{name: errors([old_fwd(fn, q, k, v, bias, plan)[0]], [want])
                   for name, fn in alts.items()},
                "bwd_on_residual": errors(kattn.fused_mha_bwd(q, k, v, bias, g, stats),
                                          kattn.mha_fused_bwd_plain(q, k, v, bias, g))}
        if none is not None or any(errs[n]["bad"] for n in ("served", "train", "old",
                                                            "bwd_on_residual")):
            raise AssertionError(f"{label}: elements out of tolerance {errs}")
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = bias.to(torch.bfloat16)[:, None, None, :]
        calls = {"served": lambda: kattn.fused_mha_fwd(q, k, v, bias, residual=False),
                 "train": lambda: kattn.fused_mha_fwd(q, k, v, bias),
                 "old": lambda: old_fwd(old, q, k, v, bias),
                 **{name: (lambda fn=fn: old_fwd(fn, q, k, v, bias, plan))
                    for name, fn in alts.items()},
                 "sdpa": lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)}
        graphs = {name: captured(fn) for name, fn in calls.items()}
        times = {name: [] for name in calls}
        for r in range(rounds):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                times[name].append(replay_ms(graphs[name]))
        del graphs
        row = {"shape": label, "b_s_h_d": [b, sq, HEADS, HEAD_DIM], "plan": plan, "errors": errs,
               "precision": fwd_precision(q, k, v, bias, plan[0], old),
               "calls_per_graph": CALLS, "rounds": rounds,
               **{f"{n}_ms": statistics.median(t) for n, t in times.items()},
               **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()},
               **fwd_bound(b, HEADS, sq, sk, residual=False),
               "train_bound_ms": fwd_bound(b, HEADS, sq, sk, residual=True)["bound_ms"],
               "card": smi}
        print("attention_ab fwd", json.dumps(row), flush=True)


def run_long(old_fwd_fn, old_bwd_fn, rounds: int, smi: str) -> None:
    """The ``--long`` comparison (see the module's note)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    route = ctypes.c_int(0)
    for label, b, sq, sk, mask_kind in LONG_SHAPES:
        q, k, v, g, mask = attention_inputs(gen, b, sq, sk, mask_kind)
        bias = kattn.mask_bias(mask)
        _, stats = kattn.fused_mha_fwd(q, k, v, bias)
        _, old_stats = old_fwd(old_fwd_fn, q, k, v, bias, (0, 0))
        want_o, want_g = (kattn.mha_fused_plain(q, k, v, bias),
                          kattn.mha_fused_bwd_plain(q, k, v, bias, g))
        errs = {"fwd": errors([kattn.fused_mha_fwd(q, k, v, bias, residual=False)[0]], [want_o]),
                "bwd": errors(kattn.fused_mha_bwd(q, k, v, bias, g, stats), want_g),
                "old_fwd": errors([old_fwd(old_fwd_fn, q, k, v, bias, (0, 0))[0]], [want_o]),
                "old_bwd": errors(old_bwd(old_bwd_fn, q, k, v, bias, g, old_stats, route),
                                  want_g)}
        if any(e["bad"] for e in errs.values()):
            raise AssertionError(f"{label}: elements out of tolerance {errs}")
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa_mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        gs = g.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)

        calls = {"fwd": lambda: kattn.fused_mha_fwd(q, k, v, bias, residual=False),
                 "fwd_train": lambda: kattn.fused_mha_fwd(q, k, v, bias),
                 "bwd": lambda: kattn.fused_mha_bwd(q, k, v, bias, g, stats),
                 "old_fwd": lambda: old_fwd(old_fwd_fn, q, k, v, bias, (0, 0), residual=False),
                 "old_bwd": lambda: old_bwd(old_bwd_fn, q, k, v, bias, g, old_stats, route),
                 "sdpa_fwd": sdpa,
                 "sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), gs)}
        graphs = {name: captured(fn) for name, fn in calls.items()}
        times = {name: [] for name in calls}
        for r in range(rounds):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                times[name].append(replay_ms(graphs[name]))
        del graphs
        times["sdpa_bwd"] = [fb - f for fb, f in zip(times["sdpa_fwd_bwd"], times["sdpa_fwd"])]
        scores = b * HEADS * sq * sk
        row = {"shape": label, "b_sq_sk_h_d": [b, sq, sk, HEADS, HEAD_DIM], "mask": mask_kind,
               "fwd_groups": kattn.long_fwd_plan(b * HEADS, sq, sk, n_sm,
                                                 kattn.long_fwd_occupancy(0, sk)),
               "errors": errs, "calls_per_graph": CALLS, "rounds": rounds,
               **{f"{n}_ms": statistics.median(t) for n, t in times.items()},
               **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()},
               "fwd_bound": fwd_bound(b, HEADS, sq, sk, residual=False),
               "bwd_bound": bwd_bound(b, HEADS, sq, sk),
               "fwd_exps": scores, "fwd_sfu_ms": sfu_ms(scores, n_sm, mhz),
               "bwd_exps": 3 * scores, "bwd_sfu_ms": sfu_ms(3 * scores, n_sm, mhz),
               "sm_mhz": mhz, "card": smi}
        print("attention_ab long", json.dumps(row), flush=True)


def old_bwd(fn, q, k, v, bias, g, stats, route=None):
    """An earlier or variant backward, called as its wrapper calls it: with
    ``route`` (a ctypes int) for the current C interface, without for the
    two-kernel one."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(g)
    dk, dv = (torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device) for _ in range(2))
    drow = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            g.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            drow.data_ptr(), strides, b, h, sq, sk, 1.0 / math.sqrt(d),
            *(() if route is None else (ctypes.byref(route),)),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("old objcavit_attention_bwd", rc)
    return dq, dk, dv


def errors(got, want) -> dict:
    """The largest absolute error of (dq, dk, dv) and the count of elements
    out of tolerance or not finite."""
    err, bad = 0.0, 0
    for x, w in zip(got, want):
        x, w = x.float(), w.float()
        diff = (x - w).abs()
        bad += int((~(diff <= ATOL_PER_MAX * float(w.abs().max()) + RTOL * w.abs())).sum())
        err = max(err, float(diff.nan_to_num(float("inf")).max()))
    return {"max_abs_err": err, "bad": bad}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", type=Path, required=True, help="an earlier attention.cu")
    parser.add_argument("--alt", type=Path, action="append", default=[],
                        help="a variant of the current attention.cu (repeatable)")
    parser.add_argument("--rounds", type=int, default=8)
    parser.add_argument("--fwd", action="store_true",
                        help="time the forward against OLD.cu's forward instead")
    parser.add_argument("--long", action="store_true",
                        help="time both directions' long routes against OLD.cu's (the current "
                             "C interface)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.long:
        run_long(load_entry(args.old, "old_fwd", build.SIGNATURES["objcavit_attention_fwd"],
                            "objcavit_attention_fwd"),
                 load_entry(args.old, "old", build.SIGNATURES["objcavit_attention_bwd"]),
                 args.rounds, smi)
        return
    if args.fwd:
        # the old source's forward has no plan arguments; variants of the
        # current one do
        old_sig = build.SIGNATURES["objcavit_attention_fwd"][:-3] + (ctypes.c_void_p,)
        alts = {f"alt{n}": load_entry(path, f"alt{n}", build.SIGNATURES["objcavit_attention_fwd"],
                                      "objcavit_attention_fwd")
                for n, path in enumerate(args.alt)}
        for name, path in zip(alts, args.alt):
            print(f"{name}: {path}", flush=True)
        run_fwd(load_entry(args.old, "old", old_sig, "objcavit_attention_fwd"), alts, args.rounds,
                smi)
        return
    p, i = ctypes.c_void_p, ctypes.c_int
    old = load_entry(args.old, "old", (p,) * 10 + (ctypes.POINTER(ctypes.c_longlong), i, i, i, i,
                                              ctypes.c_float, p))
    alts = {f"alt{n}": load_entry(path, f"alt{n}", build.SIGNATURES["objcavit_attention_bwd"])
            for n, path in enumerate(args.alt)}
    for name, path in zip(alts, args.alt):
        print(f"{name}: {path}", flush=True)
    route = ctypes.c_int(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, sq, sk in SHAPES:
        q, k, v, g, mask = attention_inputs(gen, b, sq, sk, "served")
        bias = kattn.mask_bias(mask)
        _, stats = kattn.fused_mha_fwd(q, k, v, bias)
        want = kattn.mha_fused_bwd_plain(q, k, v, bias, g)
        c0 = kattn.fused_mha_bwd.cluster_launches
        errs = {"new": errors(kattn.fused_mha_bwd(q, k, v, bias, g, stats), want),
                "old": errors(old_bwd(old, q, k, v, bias, g, stats), want),
                **{name: errors(old_bwd(fn, q, k, v, bias, g, stats, route), want)
                   for name, fn in alts.items()}}
        if errs["new"]["bad"] or errs["old"]["bad"]:
            raise AssertionError(f"{label}: elements out of tolerance {errs}")
        taken = "cluster" if kattn.fused_mha_bwd.cluster_launches > c0 else "two_kernel"
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa_mask, gs = bias.to(torch.bfloat16)[:, None, None, :], g.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)

        calls = {"new": lambda: kattn.fused_mha_bwd(q, k, v, bias, g, stats),
                 "old": lambda: old_bwd(old, q, k, v, bias, g, stats),
                 **{name: (lambda fn=fn: old_bwd(fn, q, k, v, bias, g, stats, route))
                    for name, fn in alts.items()},
                 "sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), gs),
                 "sdpa_fwd": sdpa}
        graphs = {name: captured(fn) for name, fn in calls.items()}
        times = {name: [] for name in calls}
        for r in range(args.rounds):
            order = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for name in order:
                times[name].append(replay_ms(graphs[name]))
        del graphs
        times["sdpa_bwd"] = [fb - f for fb, f in zip(times["sdpa_fwd_bwd"], times["sdpa_fwd"])]
        row = {"shape": label, "b_s_h_d": [b, sq, HEADS, HEAD_DIM], "route": taken,
               "clusters": b * HEADS,
               "clusters_resident": kattn.bwd_clusters_resident(b, HEADS, sq, sk),
               "errors": errs, "calls_per_graph": CALLS, "rounds": args.rounds,
               **{f"{n}_ms": statistics.median(t) for n, t in times.items()},
               **{f"{n}_spread_ms": [min(t), max(t)] for n, t in times.items()},
               **bwd_bound(b, HEADS, sq, sk), "card": smi}
        print("attention_ab", json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
