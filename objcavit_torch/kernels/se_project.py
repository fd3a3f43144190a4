"""Kernel 7: the MBConv epilogue, SE gate multiply + 1x1 project + bias
(+ skip), in one pass.

CUDA source: ``objcavit_torch/csrc/se_project.cu``, which replaces
``objcavit_tpu/ops/se_project_pallas.py::se_gate_project``. It is bound by
bytes on the H100 at the encoder's blocks; the source note says how its
design answers that.

``se_gate_project`` has the JAX function's name and arguments: dw_out (B,
H, W, M), gate (B, M), kernel (M, O), bias (O,), skip (B, H, W, O) or None.
Its plain version rounds where the TPU kernel does: the gate product to the
model dtype, the fp32 sum plus the fp32 bias to the model dtype, then the
skip added in that dtype. It launches the kernel for CUDA tensors and raises
on anything the kernel does not take (bf16 dw_out, kernel and skip, an fp32
bias, contiguous tensors, M and O multiples of 8); for CPU tensors it runs
the plain version. A skip whose dtype differs from dw_out's raises on any
device, as in JAX. The kernel has no backward, so the wrapper raises when
autograd would need its gradient. ``pack_project`` lays a block's project
conv out as the kernel reads it; the encoder makes it once per set of
weights. ``se_plan`` picks the kernel's tiles, stages and whether W stays in
shared memory; the C entry point takes it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from objcavit_torch.kernels.bins import check_no_grad
from objcavit_torch.kernels.build import check_launch, load_library

_ENTRY = "objcavit_se_project"
CHANNEL_ALIGN = 8  # M and O: 16-byte rows of bf16
# csrc/se_project.cu's constants: the column tiles it is built for (8 NT
# columns), the widest, consumer warps, a 64 x 64 bf16 box, its shared
# memory, and W resident up to RESIDENT_MAX
NT_CHOICES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20)
MAX_TILE_N = 8 * NT_CHOICES[-1]
CONSUMERS, BOX = 4, 64 * 128
SMEM_MAX, SM_SMEM = 232448, 228 * 1024
RESIDENT_MAX = 96 * 1024
BULK_MAX_M = 160  # whole rows of x by bulk copies up to this M
STAGES = 2
MAX_BLOCKS_PER_SM = {True: 2, False: 3}  # bulk route, tensor-map route


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


@dataclasses.dataclass(frozen=True)
class SePlan:
    nt: int  # column tile of 8 nt columns
    n_ct: int  # column tiles
    mt: int  # row tile of 64 mt rows
    resident: bool  # W in shared memory for the block's life
    bulk: bool  # x, gate, skip and out as whole row tiles by bulk copies
    stages: int  # the ring of x (+ gate, + W) chunks
    g_imgs: int  # images a row tile's gate box holds
    smem: int  # a block's shared memory, bytes
    blocks_per_sm: int
    tiles: int  # row tiles x column tiles

    def grid(self, sms: int) -> int:
        """Blocks of the persistent grid on a card of ``sms`` SMs."""
        return min(self.tiles, sms * self.blocks_per_sm)


def se_smem(mt: int, nt: int, m: int, g_imgs: int, stages: int, resident: bool, bulk: bool,
            has_skip: bool) -> int:
    """csrc's layout().total: W resident, the stages, two skip tiles, the
    consumers' output staging (and dense rows, bulk), the barriers and 1024
    bytes of alignment."""
    tm, tn, nk = 64 * mt, 8 * nt, -(-m // 64)
    nb = -(-tn // 64)
    w_res = nk * nb * BOX if resident else 0
    if bulk:
        stage = _round_up(_round_up(tm * m * 2, 128) + g_imgs * m * 2, 1024)
    else:
        stage = tm * 128 + (0 if resident else nb * BOX) + _round_up(g_imgs * 128, 1024)
    skip_tile = _round_up(tm * tn * 2, 1024) if has_skip else 0
    out = _round_up(CONSUMERS * 16 * mt * (tn + 8) * 2, 128)
    dense = _round_up(CONSUMERS * 16 * mt * tn * 2, 128) if bulk else 0
    return w_res + stages * stage + 2 * skip_tile + out + dense + (2 * stages + 5) * 8 + 1024


@functools.lru_cache(maxsize=256)
def se_plan(rows: int, hw: int, m: int, o: int, b: int, has_skip: bool = False) -> SePlan:
    """The kernel's plan for x (rows = b hw, m) -> (rows, o): the fewest
    column tiles of at most MAX_TILE_N columns, each the narrowest built
    tile that covers its share of O; row tiles of 128 rows (64 at the widest
    tile); the bulk route for narrow rows of x (m <= BULK_MAX_M) when one
    column tile, O wide, holds W resident within RESIDENT_MAX; otherwise W
    resident only where that costs no block an SM against streaming it; a
    ring of STAGES (fewer if they do not fit) and as many blocks an SM as
    fit, up to MAX_BLOCKS_PER_SM. These were the fastest, or within 3% of
    it, at each B5 shape on an H100."""
    n_ct = -(-o // MAX_TILE_N)
    nt = next(n for n in NT_CHOICES if n * 8 * n_ct >= o)
    mt = 2 if nt <= 16 else 1
    nk = -(-m // 64)
    fits_resident = n_ct == 1 and nk * -(-8 * nt // 64) * BOX <= RESIDENT_MAX
    bulk = fits_resident and 8 * nt == o and m <= BULK_MAX_M
    g_imgs = min(b, -(-(64 * mt - 1) // hw) + 1)

    def option(resident: bool) -> tuple[int, int, int]:
        stages = next(s for s in range(STAGES, 0, -1)
                      if se_smem(mt, nt, m, g_imgs, s, resident, bulk, has_skip) <= SMEM_MAX)
        smem = se_smem(mt, nt, m, g_imgs, stages, resident, bulk, has_skip)
        return stages, smem, max(1, min(MAX_BLOCKS_PER_SM[bulk], SM_SMEM // (smem + 1024)))

    resident = fits_resident and (bulk or option(True)[2] >= option(False)[2])
    stages, smem, blocks_per_sm = option(resident)
    return SePlan(nt, n_ct, mt, resident, bulk, stages, g_imgs, smem, blocks_per_sm,
                  -(-rows // (64 * mt)) * n_ct)


def se_project_eligible(m: int, o: int) -> bool:
    """Whether the kernel takes a project of these widths."""
    return m % CHANNEL_ALIGN == 0 and o % CHANNEL_ALIGN == 0


@torch.no_grad()
def pack_project(weight: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A project conv's (O, M, 1, 1) weight and (O,) bias -> (kernel (M, O)
    in the weight's dtype, bias fp32)."""
    return weight.reshape(weight.shape[0], -1).t().contiguous(), bias.float().contiguous()


def _check_skip(dw_out: torch.Tensor, skip) -> None:
    if skip is not None and skip.dtype != dw_out.dtype:
        # the unfused route's promotion (project(h) + x) would differ
        raise ValueError(f"skip dtype {skip.dtype} != dw_out dtype {dw_out.dtype}")


def project_plain(dw_out, gate, kernel, bias) -> torch.Tensor:
    """fp32 ``(dw_out * gate) @ kernel + bias`` before its rounding: the gate
    product rounded to dw_out's dtype, the weight in it, the sum in fp32."""
    gated = dw_out * gate.to(dw_out.dtype)[:, None, None, :]
    return torch.matmul(gated.float(), kernel.to(dw_out.dtype).float()) + bias.float()


def se_gate_project_plain(dw_out, gate, kernel, bias, skip=None) -> torch.Tensor:
    """Plain PyTorch version of kernel 7: (B, H, W, O) in dw_out's dtype."""
    _check_skip(dw_out, skip)
    y = project_plain(dw_out, gate, kernel, bias).to(dw_out.dtype)
    return y + skip if skip is not None else y


def check_se_project_inputs(dw_out, gate, kernel, bias, skip) -> None:
    """Raise ValueError unless the CUDA kernel takes these arguments."""
    if dw_out.dim() != 4:
        raise ValueError(f"se_project kernel takes dw_out as (B, H, W, M), got {tuple(dw_out.shape)}")
    b, h, w, m = dw_out.shape
    o = kernel.shape[-1]
    tensors = [dw_out, gate, kernel, bias] + ([skip] if skip is not None else [])
    if any(t.dtype != torch.bfloat16 for t in tensors if t is not bias):
        raise ValueError("se_project kernel takes bf16 dw_out, gate, kernel and skip, got "
                         f"{[t.dtype for t in tensors if t is not bias]}")
    if bias.dtype != torch.float32:
        raise ValueError(f"se_project kernel takes an fp32 bias, got {bias.dtype}")
    if not se_project_eligible(m, o):
        raise ValueError(f"se_project kernel needs M and O multiples of {CHANNEL_ALIGN}, "
                         f"got M={m}, O={o}")
    if gate.shape != (b, m) or kernel.shape != (m, o) or bias.shape != (o,):
        raise ValueError(f"se_project kernel takes gate (B, M), kernel (M, O), bias (O,) for "
                         f"B={b}, M={m}, O={o}, got {tuple(gate.shape)}, {tuple(kernel.shape)}, "
                         f"{tuple(bias.shape)}")
    if skip is not None and skip.shape != (b, h, w, o):
        raise ValueError(f"se_project kernel takes skip as {(b, h, w, o)}, got {tuple(skip.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("se_project kernel needs contiguous dw_out, gate, kernel, bias and skip")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"se_project kernel inputs lie on several devices: {devices}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("se_project kernel needs 16-byte aligned inputs")


def se_gate_project(dw_out, gate, kernel, bias, skip=None) -> torch.Tensor:
    """Kernel 7. dw_out (B, H, W, M) bf16, gate (B, M) bf16, kernel (M, O)
    bf16, bias (O,) fp32, skip (B, H, W, O) bf16 or None -> (B, H, W, O)
    bf16: ``(dw_out * gate) @ kernel + bias``, cast, ``+ skip``. While
    ``torch.export`` traces, the custom op ``objcavit::se_project``."""
    _check_skip(dw_out, skip)
    check_no_grad("se_gate_project", dw_out, gate, kernel, bias,
                  *([skip] if skip is not None else []))
    if torch.compiler.is_exporting():
        from objcavit_torch.kernels import ops
        return ops.se_project(dw_out, gate, kernel, bias, skip)
    if dw_out.device.type == "cpu":
        return se_gate_project_plain(dw_out, gate, kernel, bias, skip)
    if dw_out.device.type != "cuda":
        raise ValueError(f"se_project kernel runs on CUDA tensors, got {dw_out.device}")
    return se_gate_project_cuda(dw_out, gate, kernel, bias, skip)


def se_gate_project_cuda(dw_out, gate, kernel, bias, skip=None) -> torch.Tensor:
    """Kernel 7's launch on CUDA tensors: its checks, its plan, the kernel,
    the count."""
    check_se_project_inputs(dw_out, gate, kernel, bias, skip)
    b, h, w, m = dw_out.shape
    o = kernel.shape[1]
    plan = se_plan(b * h * w, h * w, m, o, b, skip is not None)
    sms = torch.cuda.get_device_properties(dw_out.device).multi_processor_count
    out = torch.empty((b, h, w, o), dtype=dw_out.dtype, device=dw_out.device)
    rc = getattr(load_library(), _ENTRY)(
        dw_out.data_ptr(), gate.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
        None if skip is None else skip.data_ptr(), out.data_ptr(), b * h * w, h * w, m, o, b,
        plan.nt, plan.n_ct, plan.mt, int(plan.resident), int(plan.bulk), plan.stages,
        plan.grid(sms),
        torch.cuda.current_stream(dw_out.device).cuda_stream,
    )
    check_launch(_ENTRY, rc)
    se_gate_project.launches += 1
    return out


se_gate_project.launches = 0
