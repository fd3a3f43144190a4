"""Kernel 5: fused multi-head attention, forward and backward.

CUDA source: ``objcavit_torch/csrc/attention.cu``, whose forward replaces
``objcavit_tpu/ops/pallas_attention.py::_attn_fwd_impl`` and whose backward
replaces ``::_attn_bwd``. It is bound by bytes on the H100, and at the
model's sizes by latency; the source note says how its design answers that.

What it computes, as the TPU kernel does: q, k and v in fp32, scores
``q k^T / sqrt(D)`` plus an fp32 additive bias of -1e30 on masked keys (not
-inf: a row whose keys are all masked is uniform over them), an fp32
softmax, the fp32 weights times v, one cast to q's dtype. Its backward
recomputes the weights and returns ``dv = w^T g``, ``ds = w (g v^T -
rowsum(g v^T w))``, ``dq = ds k / sqrt(D)``, ``dk = ds^T q / sqrt(D)``, each
in its input's dtype, and no gradient for the mask.

Both directions take one of two CUDA routes, chosen by shape in the C entry
points. With Sq and Sk up to ``CLUSTER_MAX_S`` (every model shape without
do_final_upscale) the forward holds a head's keys resident (``fwd_plan``)
and the backward is one launch of a thread-block cluster per (b, h), each
block one tile of ``KEY_TILE`` keys (``mha_bwd_by_key_tiles`` is that
decomposition's arithmetic in PyTorch). Beyond, up to ``LONG_MAX_S``, the
long route (``long_route``): the forward streams key tiles by TMA through
warpgroups (``long_fwd_plan``); the backward sums D over the key tiles in
one launch of query-tile blocks, then runs key-tile blocks for dk, dv and
query-tile blocks for dq in another (``mha_bwd_long_tiles`` is its
arithmetic). ``bwd_route`` names the route;
``fused_mha_bwd.launches`` counts both, ``fused_mha_bwd.cluster_launches``
the cluster route's.

``FusedMHA`` is the counterpart of the JAX package's custom-VJP function: a
``torch.autograd.Function`` whose forward calls ``fused_mha_fwd`` and whose
backward calls ``fused_mha_bwd``. Each of those launches its kernel for CUDA
tensors, counts the launch, and raises on anything the kernel does not take;
for CPU tensors it runs its plain PyTorch version (``mha_fused_plain``,
``mha_fused_bwd_plain``). The backward's plain version is the formula above,
not autograd of the plain forward, so the CPU tests run the arithmetic the
CUDA backward implements. ``ops.attention.mha_core(impl="kernel")`` calls
``fused_mha`` for bf16; an fp32 model on the card takes the plain forward
under autograd there (the reference route) and launches no kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from objcavit_torch.kernels.build import check_launch, load_library

_FWD = "objcavit_attention_fwd"
_BWD = "objcavit_attention_bwd"
HEAD_DIM = 32  # the kernel's head dimension
MASK_VALUE = -1e30  # the additive bias of a masked key (pallas_attention.py:27)
KEY_TILE = 64  # keys of one block of the backward's cluster
CLUSTER_MAX_S = 8 * KEY_TILE  # the portable cluster size: 8 blocks


def mask_bias(key_padding_mask: torch.Tensor | None) -> torch.Tensor | None:
    """(B, Sk) bool, True = masked -> (B, Sk) fp32 bias of 0 and -1e30."""
    if key_padding_mask is None:
        return None
    bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                       device=key_padding_mask.device)
    return bias.masked_fill_(key_padding_mask, MASK_VALUE)


def _weights(q, k, bias):
    """fp32 (at least) softmax weights (B, H, Sq, Sk) and the scale."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if bias is not None:
        scores = scores + bias.to(acc)[:, None, None, :]
    return torch.softmax(scores, dim=-1), scale


def mha_fused_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch forward of kernel 5: q (B, Sq, H, D), k and v (B, Sk, H,
    D), bias (B, Sk) fp32 or None -> (B, Sq, H, D) in q's dtype."""
    w, _ = _weights(q, k, bias)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(w.dtype)).to(q.dtype)


def mha_fused_bwd_plain(q, k, v, bias, g) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of kernel 5, the formula of
    ``pallas_attention.py::_bwd_kernel``, with the weights recomputed:
    -> (dq, dk, dv), each in its input's dtype."""
    w, scale = _weights(q, k, bias)
    gf, vf = g.to(w.dtype), v.to(w.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", w, gf)
    dw = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(w.dtype)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(w.dtype)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_bwd_by_key_tiles(q, k, v, bias, g, key_tile: int = KEY_TILE):
    """The cluster route's decomposition of the backward in PyTorch: block r
    of a cluster owns keys [r key_tile, (r + 1) key_tile). Its partial row
    terms rowsum(P_r dP_r) are summed in rank order into D; each block's dv_r
    = P_r^T g and dk_r = dS_r^T q scale are complete on their own; dq is the
    blocks' partials dS_r k_r summed in rank order, then scaled. Same
    signature and outputs as ``mha_fused_bwd_plain``."""
    w, scale = _weights(q, k, bias)
    gf, qf, kf, vf = (t.to(w.dtype) for t in (g, q, k, v))
    dw = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    tiles = [slice(s, s + key_tile) for s in range(0, k.shape[1], key_tile)]
    d = torch.zeros_like(w[..., 0])
    for r in tiles:
        d = d + (w[..., r] * dw[..., r]).sum(-1)
    dq, dks, dvs = torch.zeros_like(qf), [], []
    for r in tiles:
        ds = w[..., r] * (dw[..., r] - d[..., None])
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", w[..., r], gf))
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, r])
    return ((dq * scale).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def mha_bwd_long_tiles(q, k, v, bias, g, tile: int = KEY_TILE):
    """The long route's backward in PyTorch: a first pass sums each row's
    D = rowsum(P dP) over the key tiles in order; block r of the key tiles
    sums dv_r = P_r^T g and dk_r = dS_r^T q over the query tiles in order;
    block j of the query tiles sums dq_j = dS_j k over the key tiles in
    order, then scales. Same signature and outputs as
    ``mha_fused_bwd_plain``."""
    w, scale = _weights(q, k, bias)
    gf, qf, kf, vf = (t.to(w.dtype) for t in (g, q, k, v))
    dw = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    q_tiles = [slice(s, s + tile) for s in range(0, q.shape[1], tile)]
    k_tiles = [slice(s, s + tile) for s in range(0, k.shape[1], tile)]
    d = torch.zeros_like(w[..., 0])
    for r in k_tiles:
        d = d + (w[..., r] * dw[..., r]).sum(-1)
    ds = w * (dw - d[..., None])
    dks, dvs = [], []
    for r in k_tiles:
        dk_r, dv_r = torch.zeros_like(kf[:, r]), torch.zeros_like(vf[:, r])
        for j in q_tiles:
            dv_r = dv_r + torch.einsum("bhqk,bqhd->bkhd", w[..., j, r], gf[:, j])
            dk_r = dk_r + torch.einsum("bhqk,bqhd->bkhd", ds[..., j, r], qf[:, j])
        dks.append(dk_r * scale)
        dvs.append(dv_r)
    dqs = []
    for j in q_tiles:
        dq_j = torch.zeros_like(qf[:, j])
        for r in k_tiles:
            dq_j = dq_j + torch.einsum("bhqk,bkhd->bqhd", ds[..., j, r], kf[:, r])
        dqs.append(dq_j * scale)
    return (torch.cat(dqs, 1).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


RESIDENT_MAX_KEYS = 8 * KEY_TILE  # keys the forward holds in shared memory
MAX_KEY_GROUPS = 4  # the C entry point's kMaxKeyGroups
LONG_MAX_S = 8192  # queries and keys of a long-route launch (the C entry's kLongMaxS)
MAX_LONG_GROUPS = 3  # warpgroups of a long forward block (kMaxLongGroups)
LONG_SATURATING_WGS = 4  # warpgroups an SM needs to hide their latencies (PERF.md §6)


def long_route(s_q: int, s_k: int) -> bool:
    """Whether kernel 5 takes its long routes at these lengths: Sq or Sk
    above ``CLUSTER_MAX_S`` (the C entry points' rule, both directions)."""
    return max(s_q, s_k) > CLUSTER_MAX_S


def fwd_plan(bh: int, s_q: int, s_k: int, n_sm: int) -> tuple[int, int] | None:
    """The forward's launch plan, which the wrapper passes to the C entry
    point: (m-tiles of 16 query rows a block, key groups) for the kernel
    that holds a head's keys resident, or None on the long route
    (``long_fwd_plan``). The m-tiles make the B*H heads' blocks fill
    the ``n_sm`` SMs once (at most 8 a block), the key groups as many as 16
    warps, the key tiles and ``MAX_KEY_GROUPS`` allow. More than one key
    group changes the fp32 rounding of the sums against the first port's
    order, not their accuracy (PERF.md §6)."""
    n_kt = -(-s_k // KEY_TILE)
    if long_route(s_q, s_k):
        return None
    m_tiles = -(-s_q // 16)
    per_head = max(1, n_sm // bh)  # blocks a head may take
    rows = min(8, -(-m_tiles // per_head))
    return rows, min(16 // rows, MAX_KEY_GROUPS, n_kt)


def key_group_tiles(n_kt: int, groups: int) -> list[range]:
    """Key group k's tiles of ``n_kt`` among ``groups``, the C kernels'
    group_first_tile: group 0 holds tile 0, none more than ceil(n / G)."""
    first = [(n_kt * k + groups - 1) // groups for k in range(groups + 1)]
    return [range(first[k], first[k + 1]) for k in range(groups)]


def long_fwd_plan(bh: int, s_q: int, s_k: int, n_sm: int, per_sm: dict[int, int]) -> int:
    """The long forward's warpgroups a block, each a key group over the
    block's 64 query rows. ``per_sm`` maps a count to the blocks of that
    size an SM holds at once (``long_fwd_occupancy``). A count's cost is its
    waves of blocks times its longest key group's tiles times the
    warpgroups that share an SM, at least ``LONG_SATURATING_WGS`` (with
    fewer an SM's warpgroups cover each other's latencies less, and each
    runs no faster); the least cost wins, and of equal costs the fewest
    groups (less merging)."""
    n_kt = -(-s_k // KEY_TILE)
    blocks = -(-s_q // KEY_TILE) * bh
    best = None
    for groups in range(1, min(MAX_LONG_GROUPS, n_kt) + 1):
        resident = max(1, per_sm[groups])
        waves = -(-blocks // (n_sm * resident))
        cost = waves * -(-n_kt // groups) * max(resident * groups, LONG_SATURATING_WGS)
        if best is None or cost < best[0]:
            best = (cost, groups)
    return best[1]


@functools.lru_cache(maxsize=None)
def long_fwd_occupancy(device: int, s_k: int) -> dict[int, int]:
    """{warpgroups a block: blocks an SM of the card holds at once} for the
    long forward at Sk keys (its shared memory holds their bias)."""
    lib, blocks = load_library(), ctypes.c_int(0)
    with torch.cuda.device(device):
        out = {}
        for groups in range(1, MAX_LONG_GROUPS + 1):
            check_launch("objcavit_attention_long_fwd_blocks",
                         lib.objcavit_attention_long_fwd_blocks(groups, s_k, ctypes.byref(blocks)))
            out[groups] = blocks.value
    return out


def bwd_route(s_q: int, s_k: int) -> str:
    """The backward's CUDA route at these lengths, the C entry point's rule:
    'cluster' (one launch) or 'long' (a launch that sums the row term, then
    one of key-tile and query-tile blocks)."""
    return "long" if long_route(s_q, s_k) else "cluster"


def bwd_clusters_resident(b: int, h: int, s_q: int, s_k: int) -> int:
    """How many of the cluster route's clusters (one a (b, h)) the current
    card holds at once at these lengths; fewer than b * h means waves."""
    clusters = ctypes.c_int(0)
    check_launch("objcavit_attention_bwd_clusters", load_library().objcavit_attention_bwd_clusters(
        b, h, s_q, s_k, ctypes.byref(clusters)))
    return clusters.value


def _device_checked(q: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel runs on CUDA tensors, got {q.device}")
    return True


def check_attention_inputs(q, k, v, bias) -> None:
    """Raise ValueError unless the CUDA kernels take these arguments."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention kernel takes q, k, v as (B, S, H, D)")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree")
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel takes head dimension {HEAD_DIM}, got {d}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"attention kernel takes bf16 q, k, v, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"attention kernel needs {name} unit-stride in D, its other "
                             f"strides multiples of 8 and 16-byte alignment; got strides "
                             f"{t.stride()}")
    devices = {t.device for t in (q, k, v) + (() if bias is None else (bias,))}
    if len(devices) != 1:
        raise ValueError(f"attention kernel inputs lie on several devices: {devices}")
    if max(q.shape[1], k.shape[1]) > LONG_MAX_S:
        raise ValueError(f"attention kernel takes at most {LONG_MAX_S} queries and keys, got "
                         f"Sq {q.shape[1]}, Sk {k.shape[1]}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (b, k.shape[1])
                             or not bias.is_contiguous()):
        raise ValueError(f"attention kernel takes the bias as contiguous fp32 (B, Sk), got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))


def residual_needed(*tensors: torch.Tensor) -> bool:
    """Whether autograd may call kernel 5's backward on a forward of these
    inputs: grad mode is on and one of them requires grad. Otherwise (under
    ``torch.no_grad()`` or inference mode, or with no input requiring grad)
    the forward writes no residual."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_mha_fwd(q, k, v, bias=None,
                  residual: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """-> (o (B, Sq, H, D) in q's dtype, the residual for the backward: each
    row's max and log-sum, (2, B * H, Sq) fp32 (log2 units on the long
    route); None on the CPU, or with ``residual=False``, where the kernel
    writes none)."""
    if not _device_checked(q):
        return mha_fused_plain(q, k, v, bias), None
    check_attention_inputs(q, k, v, bias)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    stats = (torch.empty((2, b * h, sq), dtype=torch.float32, device=q.device) if residual
             else None)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = fwd_plan(b * h, sq, sk, n_sm)
    if plan is None:
        per_sm = long_fwd_occupancy(q.device.index or 0, sk)
        plan = (0, long_fwd_plan(b * h, sq, sk, n_sm, per_sm))
    rc = getattr(load_library(), _FWD)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        o.data_ptr(), None if stats is None else stats.data_ptr(), _strides(q, k, v), b, h, sq,
        sk, 1.0 / math.sqrt(d), *plan, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(_FWD, rc)
    fused_mha_fwd.launches += 1
    return o, stats


def fused_mha_bwd(q, k, v, bias, g, stats) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dq, dk, dv) for the gradient ``g`` (B, Sq, H, D) of the output;
    ``stats`` is the forward's residual."""
    if not _device_checked(q):
        return mha_fused_bwd_plain(q, k, v, bias, g)
    check_attention_inputs(q, k, v, bias)
    b, sq, h, d = q.shape
    if g.dtype != q.dtype or g.shape != q.shape or not g.is_contiguous() or g.device != q.device:
        raise ValueError(f"attention kernel takes g as contiguous {q.dtype} {tuple(q.shape)}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if stats is None or stats.shape != (2, b * h, sq) or stats.device != q.device:
        raise ValueError("attention kernel's backward needs the forward's residual")
    sk = k.shape[1]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    drow = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)  # the long route's D
    route = ctypes.c_int(0)
    rc = getattr(load_library(), _BWD)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        g.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        drow.data_ptr(), _strides(q, k, v), b, h, sq, sk, 1.0 / math.sqrt(d),
        ctypes.byref(route), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(_BWD, rc)
    fused_mha_bwd.launches += 1
    fused_mha_bwd.cluster_launches += route.value == 1
    return dq, dk, dv


fused_mha_fwd.launches = 0
fused_mha_bwd.launches = 0
fused_mha_bwd.cluster_launches = 0


class FusedMHA(torch.autograd.Function):
    """Attention with the recomputing backward (the JAX package's ``_attn``
    custom VJP); no gradient reaches the bias. ``residual`` says whether the
    forward keeps the residual for a backward (``residual_needed``, decided
    by the caller: inside ``forward`` grad mode is always off)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, residual):
        o, stats = fused_mha_fwd(q, k, v, bias, residual)
        ctx.save_for_backward(q, k, v, bias, stats)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, stats = ctx.saved_tensors
        dq, dk, dv = fused_mha_bwd(q, k, v, bias, g.contiguous(), stats)
        return dq, dk, dv, None, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, H, D), mask (B, Sk) bool True =
    masked -> (B, Sq, H, D): ``pallas_mha``'s signature. The residual is
    written only where a backward may read it (``residual_needed``). While
    ``torch.export`` traces, the forward alone, as the custom op
    ``objcavit::attention_fwd`` (an exported program has no backward)."""
    if torch.compiler.is_exporting():
        if residual_needed(q, k, v):
            raise RuntimeError("an exported program runs kernel 5's forward alone, but autograd "
                               "needs its gradient here: export under torch.no_grad()")
        from objcavit_torch.kernels import ops
        return ops.attention_fwd(q, k, v, mask_bias(key_padding_mask))
    return FusedMHA.apply(q, k, v, mask_bias(key_padding_mask), residual_needed(q, k, v))
