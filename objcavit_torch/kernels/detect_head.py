"""Kernel 6: the YOLOv7 detect head, a 1x1 conv with each anchor's class
max and argmax in its epilogue.

CUDA source: ``objcavit_torch/csrc/detect_head.cu``, which replaces
``objcavit_tpu/ops/detect_head_pallas.py::fused_detect_head``. It is bound
by tensor-core operations on the H100 (128 GFLOP per NYU request of 8); the
source note says how its design (wgmma, TMA, a resident feature tile, a
persistent grid) answers that.

The weights are repacked once, by ``pack_detect_head``, into the layout the
kernel reads (the JAX package folds the same repack into its trace):

* ``wcls`` (3, ncp, Cin): anchor a's nc class columns, one row per class,
  rows nc..ncp zero (ncp a multiple of 128), with ``bcls`` (3, ncp) fp32
  whose pad entries are -1e30, as the TPU kernel's;
* ``w5c`` (128, Cin): the 15 box/objectness columns and the 3 nm mask
  coefficient columns packed as [a0 box 5 | a1 | a2 | a0 coef nm | a1 | a2 |
  zero pad], with ``b5c`` (128,) fp32.

``fused_detect_head`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; for CPU tensors it runs
``fused_detect_head_plain``: an fp32 product of the bf16 values plus the
fp32 bias, rounded to the input dtype, then ``max`` and ``argmax`` (the
first maximum). The kernel is forward-only, so the wrapper raises when
autograd would need its gradient. The detector takes it for bf16 only: an
fp32 detector on the card runs the plain version, the reference route.

The kernel splits an anchor's class columns over blocks and merges their
(max, index) pairs with a 64-bit ``atomicMax``; ``encode_class_key`` and
``decode_class_key`` are the Python twin of that key.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from objcavit_torch.kernels.bins import check_no_grad
from objcavit_torch.kernels.build import check_launch, load_library

_ENTRY = "objcavit_detect_head"
N_ANCHORS = 3
N_BOX = 5
PACKED_OTHER = 128  # box/objectness + coefficient columns of all 3 anchors
COL_TILE = 128  # the kernel's column tile: ncp is a multiple of it
CHANNEL_CHUNK = 64  # the kernel stages Cin in chunks of 64
PAD_BIAS = -1e30  # pad classes' bias: far below any logit, finite in bf16
RING_MIN_STAGES, RING_MAX_STAGES = 4, 8  # the kernel's weight ring: 16 KB stages
SMEM_LIMIT = 232448  # shared memory a block may take on Hopper (227 KB)


@dataclass(frozen=True)
class PackedDetectHead:
    """One level's detect conv in the kernel's layout (see the module note)."""

    wcls: torch.Tensor  # (3, ncp, Cin) model dtype
    bcls: torch.Tensor  # (3, ncp) fp32
    w5c: torch.Tensor  # (128, Cin) model dtype
    b5c: torch.Tensor  # (128,) fp32
    num_classes: int
    nm: int


@torch.no_grad()
def pack_detect_head(weight: torch.Tensor, bias: torch.Tensor, num_classes: int, nm: int,
                     dtype: torch.dtype) -> PackedDetectHead:
    """Repack a detect conv, ``weight`` (3 no, Cin) or (3 no, Cin, 1, 1) and
    ``bias`` (3 no,), with no = 5 + nc + nm; the weight is cast to ``dtype``,
    the bias kept in fp32."""
    no = N_BOX + num_classes + nm
    weight = weight.reshape(weight.shape[0], -1)
    if weight.shape[0] != N_ANCHORS * no or bias.shape != (N_ANCHORS * no,):
        raise ValueError(f"detect conv of {tuple(weight.shape)} and bias {tuple(bias.shape)} "
                         f"does not hold 3 anchors of {no} outputs")
    if N_ANCHORS * (N_BOX + nm) > PACKED_OTHER:
        raise ValueError(f"the packed tile holds 3 (5 + nm) <= {PACKED_OTHER} columns, got nm={nm}")
    cin = weight.shape[1]
    ncp = -(-num_classes // COL_TILE) * COL_TILE
    dev = weight.device
    wcls = torch.zeros((N_ANCHORS, ncp, cin), dtype=dtype, device=dev)
    bcls = torch.full((N_ANCHORS, ncp), PAD_BIAS, dtype=torch.float32, device=dev)
    for a in range(N_ANCHORS):
        lo = a * no + N_BOX
        wcls[a, :num_classes] = weight[lo:lo + num_classes]
        bcls[a, :num_classes] = bias[lo:lo + num_classes].float()
    sel = [a * no + c for a in range(N_ANCHORS) for c in range(N_BOX)]
    sel += [a * no + N_BOX + num_classes + c for a in range(N_ANCHORS) for c in range(nm)]
    sel = torch.tensor(sel, device=dev)
    w5c = torch.zeros((PACKED_OTHER, cin), dtype=dtype, device=dev)
    b5c = torch.zeros(PACKED_OTHER, dtype=torch.float32, device=dev)
    w5c[:len(sel)] = weight[sel]
    b5c[:len(sel)] = bias[sel].float()
    return PackedDetectHead(wcls.contiguous(), bcls, w5c, b5c, num_classes, nm)


def class_logits_plain(flat: torch.Tensor, packed: PackedDetectHead) -> torch.Tensor:
    """(B, S, 3, nc) fp32 class logits, each rounded to ``flat.dtype``."""
    b, s, cin = flat.shape
    x = flat.reshape(b * s, cin).float()
    nc = packed.num_classes
    out = [
        (x @ packed.wcls[a, :nc].float().T + packed.bcls[a, :nc]).to(flat.dtype).float()
        for a in range(N_ANCHORS)
    ]
    return torch.stack(out, dim=1).reshape(b, s, N_ANCHORS, nc)


def fused_detect_head_plain(flat: torch.Tensor, packed: PackedDetectHead):
    """Plain PyTorch version. flat (B, S, Cin) -> (y5 (B, S, 3, 5), coef
    (B, S, 3, nm) in flat's dtype; cls_max (B, S, 3) fp32, cls_arg (B, S, 3)
    int32)."""
    b, s, cin = flat.shape
    nm = packed.nm
    other = (flat.reshape(b * s, cin).float() @ packed.w5c.float().T + packed.b5c).to(flat.dtype)
    y5 = other[:, :N_ANCHORS * N_BOX].reshape(b, s, N_ANCHORS, N_BOX)
    coef = other[:, N_ANCHORS * N_BOX:N_ANCHORS * (N_BOX + nm)].reshape(b, s, N_ANCHORS, nm)
    logits = class_logits_plain(flat, packed)
    return y5, coef, logits.amax(-1), logits.argmax(-1).to(torch.int32)


def smem_bytes(block_rows: int, cin: int, ncp: int) -> int:
    """The least shared memory the kernel takes for a block of ``block_rows``
    positions: the resident feature tile, the shortest weight ring, the
    biases, the barriers and 1 KB of alignment (``csrc/detect_head.cu``'s
    ``smem_bytes``; the kernel deepens the ring into what is left)."""
    return (1024 + block_rows * cin * 2 + RING_MIN_STAGES * COL_TILE * CHANNEL_CHUNK * 2
            + (N_ANCHORS * ncp + PACKED_OTHER) * 4 + (2 * RING_MAX_STAGES + 4) * 8)


def block_rows_for(cin: int, ncp: int) -> int:
    """128 positions a block where that block fits in shared memory (Cin up to
    512 at 1203 classes), else 64; 0 if neither fits."""
    for rows in (128, 64):
        if smem_bytes(rows, cin, ncp) <= SMEM_LIMIT:
            return rows
    return 0


def encode_class_key(value: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit merge key of fp32 ``value`` at int ``index``, less
    2^63 so that torch's signed int64 order is the kernel's unsigned order:
    high word the order-preserving bits of the value (-0.0 taken as +0.0),
    low word 0xFFFFFFFF - index, so a larger value wins and equal values go
    to the smaller index."""
    bits = torch.where(value == 0, torch.zeros_like(value), value).float().contiguous()
    u = bits.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    enc = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return (enc - 0x80000000) * 2 ** 32 + (0xFFFFFFFF - index.to(torch.int64))


def decode_class_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fp32 value, int32 index) of keys made by ``encode_class_key``."""
    enc = torch.div(key, 2 ** 32, rounding_mode="floor") + 0x80000000
    low = key - (enc - 0x80000000) * 2 ** 32
    u = torch.where(enc >= 0x80000000, enc & 0x7FFFFFFF, 0xFFFFFFFF - enc)
    value = (u - ((u >= 0x80000000).to(torch.int64) << 32)).to(torch.int32).view(torch.float32)
    return value, (0xFFFFFFFF - low).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_detect_head_inputs(flat: torch.Tensor, packed: PackedDetectHead) -> None:
    """Raise ValueError unless the CUDA kernel takes these arguments."""
    if flat.dim() != 3:
        raise ValueError(f"detect head kernel takes flat as (B, S, Cin), got {tuple(flat.shape)}")
    cin = flat.shape[2]
    if flat.dtype != torch.bfloat16 or packed.wcls.dtype != torch.bfloat16 \
            or packed.w5c.dtype != torch.bfloat16:
        raise ValueError(f"detect head kernel takes bf16 features and weights, got {flat.dtype}, "
                         f"{packed.wcls.dtype} and {packed.w5c.dtype}")
    if packed.bcls.dtype != torch.float32 or packed.b5c.dtype != torch.float32:
        raise ValueError("detect head kernel takes fp32 biases")
    if cin % CHANNEL_CHUNK:
        raise ValueError(f"detect head kernel needs Cin % {CHANNEL_CHUNK} == 0, got Cin={cin}")
    ncp = packed.wcls.shape[1]
    if packed.wcls.shape != (N_ANCHORS, ncp, cin) or ncp % COL_TILE \
            or not 0 < packed.num_classes <= ncp or packed.w5c.shape != (PACKED_OTHER, cin):
        raise ValueError(f"detect head kernel takes packed weights for Cin={cin}, got wcls "
                         f"{tuple(packed.wcls.shape)} and w5c {tuple(packed.w5c.shape)}")
    if packed.bcls.shape != (N_ANCHORS, ncp) or packed.b5c.shape != (PACKED_OTHER,):
        raise ValueError("detect head kernel: bias shapes do not match the packed weights")
    if not block_rows_for(cin, ncp):
        raise ValueError(f"detect head kernel: a 64-row feature tile of Cin={cin} with ncp={ncp} "
                         f"does not fit in shared memory ({smem_bytes(64, cin, ncp)} > "
                         f"{SMEM_LIMIT} bytes)")
    tensors = (flat, packed.wcls, packed.bcls, packed.w5c, packed.b5c)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("detect head kernel needs contiguous features and packed weights")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"detect head kernel inputs lie on several devices: {devices}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("detect head kernel needs 16-byte aligned inputs")


def _launch(flat: torch.Tensor, packed: PackedDetectHead, grid: int):
    """Launch kernel 6 on at most ``grid`` blocks and count the launch."""
    check_detect_head_inputs(flat, packed)
    b, s, cin = flat.shape
    m, nm = b * s, packed.nm
    dev = flat.device
    y5 = torch.empty((b, s, N_ANCHORS, N_BOX), dtype=flat.dtype, device=dev)
    coef = torch.empty((b, s, N_ANCHORS, nm), dtype=flat.dtype, device=dev)
    cls_max = torch.empty((b, s, N_ANCHORS), dtype=torch.float32, device=dev)
    cls_arg = torch.empty((b, s, N_ANCHORS), dtype=torch.int32, device=dev)
    keys = torch.empty((b, s, N_ANCHORS), dtype=torch.int64, device=dev)  # zeroed by the entry
    ncp = packed.wcls.shape[1]
    rc = getattr(load_library(), _ENTRY)(
        flat.data_ptr(), packed.wcls.data_ptr(), packed.bcls.data_ptr(), packed.w5c.data_ptr(),
        packed.b5c.data_ptr(), y5.data_ptr(), coef.data_ptr(), cls_max.data_ptr(),
        cls_arg.data_ptr(), keys.data_ptr(), m, cin, packed.num_classes, ncp, nm,
        block_rows_for(cin, ncp), grid, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(_ENTRY, rc)
    fused_detect_head.launches += 1
    return y5, coef, cls_max, cls_arg


def _route(flat: torch.Tensor) -> bool:
    """True for a CUDA launch, False for the plain version on the CPU."""
    check_no_grad("fused_detect_head", flat)
    if flat.device.type == "cpu":
        return False
    if flat.device.type != "cuda":
        raise ValueError(f"detect head kernel runs on CUDA tensors, got {flat.device}")
    return True


def fused_detect_head(flat: torch.Tensor, packed: PackedDetectHead):
    """Kernel 6. flat (B, S, Cin) bf16 -> (y5 (B, S, 3, 5), coef (B, S, 3,
    nm) bf16; cls_max (B, S, 3) fp32, cls_arg (B, S, 3) int32): the dense
    head flat @ W + b reduced over each anchor's classes. While
    ``torch.export`` traces, the custom op ``objcavit::detect_head``, which
    takes ``packed`` as its tensors and ints."""
    if torch.compiler.is_exporting():
        check_no_grad("fused_detect_head", flat)
        from objcavit_torch.kernels import ops
        return ops.detect_head(flat, packed.wcls, packed.bcls, packed.w5c, packed.b5c,
                               packed.num_classes, packed.nm)
    if not _route(flat):
        return fused_detect_head_plain(flat, packed)
    return fused_detect_head_cuda(flat, packed)


def fused_detect_head_cuda(flat: torch.Tensor, packed: PackedDetectHead):
    """Kernel 6's launch on CUDA tensors, one block an SM: its checks, the
    kernel, the count."""
    dev = flat.device
    return _launch(flat, packed, _sm_count(dev.index if dev.index is not None
                                           else torch.cuda.current_device()))


def _fused_detect_head_on_grid(flat: torch.Tensor, packed: PackedDetectHead, grid: int):
    """Kernel 6 on a grid of at most ``grid`` blocks, not one an SM: a test
    seam for the share edges (``utils/kernel_io.py::share_edge_grids``).
    CUDA tensors only."""
    if not _route(flat):
        raise ValueError("_fused_detect_head_on_grid launches the kernel: it takes CUDA tensors")
    return _launch(flat, packed, grid)


fused_detect_head.launches = 0
