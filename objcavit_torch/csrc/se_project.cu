// Fused MBConv epilogue: SE gate multiply + 1x1 project + bias (+ skip).
//
// Replaces the TPU kernel objcavit_tpu/ops/se_project_pallas.py::
// se_gate_project (_kernel_skip, _kernel_noskip):
//
//   out[r, o] = bf16( bf16( sum_k bf16(x[r, k] * gate[b(r), k]) * w[k, o] + bias[o] )
//                     + skip[r, o] )                     (no skip: the inner bf16)
//
// x (rows = B*H*W, M) bf16 is the depthwise block's output, gate (B, M) bf16
// the SE sigmoid, w (M, O) bf16 the folded project conv, bias (O,) fp32 and
// skip / out (rows, O) bf16. The gate product is rounded to bf16 (the model
// dtype), the sum is fp32, the bias is added in fp32 and the result cast
// before the skip is added, as in the TPU kernel. The gate stays on x:
// folding it into w per image (a batched GEMM's route) rounds elsewhere.
//
// What bounds it on the H100: bytes. Per row it reads M and writes O <= M/4
// bf16 values and does 2 M O flops: about O flops per byte, under the
// card's ~295 bf16 flops per byte at every B5 block but stage 6's last
// (O = 512). The unfused route writes the gated (rows, M) tensor and reads
// it back for the project conv, then adds the bias and the skip in passes
// of their own; this kernel reads x once and writes only out.
//
// What the fused-MBConv slice's design lost (31% of its bound over a
// forward, behind a batched GEMM at three shapes) and what this one does:
// - It had one stage and no overlap: each 32-wide chunk of M loaded x
//   through registers, waited for its weights, passed two barriers, and at
//   the 240x320 shapes (M = 48, 24) a block's life was one or two chunks.
//   Here a persistent grid (two blocks an SM) walks tiles of 64 MT rows;
//   a producer warp keeps a ring of stages in flight by TMA on mbarriers
//   (the x box, 64 rows x 64 of M, 128-byte swizzled; the gate box of the
//   images the tile touches; W's boxes when W is streamed), and the skip
//   tile of each row tile comes by TMA into a ring of two, so the next
//   tile's loads overlap this tile's products and epilogue.
// - Its column tile was 64 wide: at O = 24 and 40 half its warps held only
//   padding. Here the tile is TN = 8 NT columns with NT fitted to O (24,
//   40, 64, 128; 304 as two of 160; 512 as four of 128), every warp owns
//   16 MT rows of all TN columns, and MT = 2 but at TN = 160 (the
//   accumulators of 32 x 160 would not fit a thread's registers).
// - It re-read the gate from global memory for every 16 bytes of x. Here
//   the gate comes with each chunk in shared memory and multiplies the A
//   fragments in registers (bf16x2 products of bf16 values: exact, then
//   rounded once, as PyTorch and JAX round x * gate), each row by its own
//   image's gate, so a tile that crosses images (H*W = 300) is right.
// - W is resident in shared memory for the block's life where it fits
//   (one column tile and M O 2 bytes <= 96 KB) and that costs no block an
//   SM, else its 64-row chunks come with x through the ring (from L2). On
//   an H100, at 240 -> 64 three blocks an SM streaming W beat two keeping
//   it by a fifth; at 384 -> 128 the two ran even.
// - The epilogue stages bias-added, rounded values in shared memory and
//   writes 16-byte coalesced rows, adding the skip there. No atomics: two
//   calls are bitwise equal.
// - Narrow rows (M <= 160, one column tile as wide as O: the 240x320 and
//   120x160 shapes) take the bulk route: a row tile of x is one contiguous
//   run of memory, and so are its images' gates, its skip and its output,
//   so each moves by one 1-D bulk copy (cp.async.bulk) on the mbarriers and
//   each warp's output rows by one bulk store. On an H100, TMA boxes of
//   48- and 96-byte rows read x at only 1.3-1.9 TB/s there (a build that
//   did nothing but its loads). x rows sit unswizzled at M * 2 bytes; the
//   k pairs past M of the last k16 step are zeroed in registers.
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) does the products: the
// shapes are bound by bytes, but for stage 6's 3072 -> 512.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 4;                 // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kBox = 64 * 128;                // a 64 x 64 bf16 box, bytes
constexpr int kMaxSmem = 232448;
constexpr int kMaxResident = 96 * 1024;       // W kept in shared memory up to this

struct Job {
  int rows, hw, m, o, b;
  int nk;        // chunks of 64 along M (the tensor-map route)
  int n_ct;      // column tiles
  int n_tiles;   // row tiles x column tiles
  int g_imgs;    // images a row tile's gate holds
  int stages;
  int resident;  // W in shared memory for the block's life
  int has_skip;
  int bulk;      // x, gate, skip and out as whole row tiles by bulk copies
};

struct Layout {
  int w_res, stage, x_off, w_off, gate_off, skip_tile, skip_off, out_off, dense_off, bars_off,
      total;
};

__host__ __device__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// offsets from a 1024-byte aligned base: [W resident][stages][skip ring of
// two][out staging][dense out rows (bulk)][barriers]; total includes the
// alignment slack. A stage holds a 64 x 64 box of x per 64-row unit, the
// gate box and W's boxes when streamed, or (bulk) the tile's rows of x and
// its images' gates, whole
__host__ __device__ inline Layout layout(int mt, int nt, const Job& j) {
  const int tm = 64 * mt, tn = 8 * nt, nb = (tn + 63) / 64;
  Layout l;
  l.w_res = j.resident ? j.nk * nb * kBox : 0;
  l.x_off = 0;
  if (j.bulk) {
    l.w_off = round_up(tm * j.m * 2, 128);
    l.gate_off = l.w_off;
    l.stage = round_up(l.gate_off + j.g_imgs * j.m * 2, 1024);
  } else {
    l.w_off = tm * 128;
    l.gate_off = l.w_off + (j.resident ? 0 : nb * kBox);
    l.stage = l.gate_off + round_up(j.g_imgs * 128, 1024);
  }
  l.skip_tile = j.has_skip ? round_up(tm * tn * 2, 1024) : 0;
  l.skip_off = l.w_res + j.stages * l.stage;
  l.out_off = l.skip_off + 2 * l.skip_tile;
  l.dense_off = l.out_off + round_up(kConsumers * 16 * mt * (tn + 8) * 2, 128);
  l.bars_off = l.dense_off + (j.bulk ? round_up(kConsumers * 16 * mt * tn * 2, 128) : 0);
  l.total = l.bars_off + (2 * j.stages + 5) * 8 + 1024;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a broken pipeline) traps, so it fails the launch instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of a 2-D tensor map at (inner c0, outer c1) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` of shared memory to contiguous global memory, in the bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the bulk stores issued so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(a * g) of two bf16 pairs: the products are exact, rounded once
__device__ __forceinline__ uint32_t gate_mul(uint32_t a, uint32_t g) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&g));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// one k16 step of a warp's products: B of all NT n8 tiles from W's box
// group `wbox` (rows kb*16.. of its 64, 128-byte swizzled), A of each of its
// MT m16 tiles from `a_addr` by ldmatrix, gated in registers by the gate
// values at g[mt][h] (rows g and g + 8; the k pair 2tq, then +8 at 16
// bytes on); k pairs past M are zeroed when `lo_ok` / `hi_ok` is false
template <int MT, int NT>
__device__ __forceinline__ void k16_step(float (&acc)[MT][NT][4], uint32_t wbox, int kb,
                                         const uint32_t (&a_addr)[MT],
                                         const unsigned char* const (&gp)[MT][2], bool lo_ok,
                                         bool hi_ok, int lane) {
  uint32_t bfr[(NT + 1) / 2 * 2][2];
#pragma unroll
  for (int np = 0; np < (NT + 1) / 2; ++np) {
    // W (k, n) of the box group: box n / 64, row k, 16-byte column
    // (n % 64) / 8 swizzled by k % 8
    const int j = lane >> 3;
    const int k = kb * 16 + (j & 1) * 8 + (lane & 7);
    const int n = np * 16 + (j >> 1) * 8;
    uint32_t r[4];
    ldmatrix_x4_trans(r, wbox + (n >> 6) * kBox + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4));
    bfr[2 * np][0] = r[0];
    bfr[2 * np][1] = r[1];
    bfr[2 * np + 1][0] = r[2];
    bfr[2 * np + 1][1] = r[3];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t a[4];
    ldmatrix_x4(a, a_addr[mt]);
    // a0: (row g, k 2tq), a1: (row g + 8, k 2tq), a2: (row g, k 2tq + 8), a3: (g + 8, 2tq + 8)
    a[0] = lo_ok ? gate_mul(a[0], *reinterpret_cast<const uint32_t*>(gp[mt][0])) : 0u;
    a[1] = lo_ok ? gate_mul(a[1], *reinterpret_cast<const uint32_t*>(gp[mt][1])) : 0u;
    a[2] = hi_ok ? gate_mul(a[2], *reinterpret_cast<const uint32_t*>(gp[mt][0] + 16)) : 0u;
    a[3] = hi_ok ? gate_mul(a[3], *reinterpret_cast<const uint32_t*>(gp[mt][1] + 16)) : 0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a, bfr[nt][0], bfr[nt][1]);
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads) se_project_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_gate, const __grid_constant__ CUtensorMap tm_skip,
    const bf16* __restrict__ x, const bf16* __restrict__ gate, const bf16* __restrict__ skip,
    const float* __restrict__ bias, bf16* __restrict__ out, const Job job) {
  constexpr int TM = 64 * MT, TN = 8 * NT, NB = (TN + 63) / 64;
  constexpr int kOutPitch = TN + 8;  // staged output row, bf16
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* base = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  const Layout L = layout(MT, NT, job);
  const uint32_t full = sbase + L.bars_off, empty = full + 8 * job.stages;
  const uint32_t wbar = empty + 8 * job.stages, skip_full = wbar + 8, skip_empty = skip_full + 16;
  const int S = job.stages;
  const int pitch = job.m * 2;  // bytes of a row of x or of the gate (bulk)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init(wbar, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(skip_full + 8 * i, 1);
      mbar_init(skip_empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    if (lane == 0) {
      if (job.resident) {
        mbar_expect_tx(wbar, job.nk * NB * kBox);
        for (int kc = 0; kc < job.nk; ++kc)
          for (int bi = 0; bi < NB; ++bi)
            tma_load(sbase + (kc * NB + bi) * kBox, &tm_w, wbar, bi * 64, kc * 64);
      }
      const uint32_t stage_bytes =
          TM * 128 + job.g_imgs * 128 + (job.resident ? 0 : NB * kBox);
      int s = 0, ph = 0, ts = 0, tph = 0;
      for (int t = blockIdx.x; t < job.n_tiles; t += gridDim.x) {
        const int rt = t / job.n_ct, ct = t - rt * job.n_ct;
        const int r0 = rt * TM, n0 = ct * TN;
        const int img0 = r0 / job.hw;
        const int n_rows = min(TM, job.rows - r0);
        if (job.has_skip) {
          mbar_wait(skip_empty + 8 * ts, tph ^ 1);
          const uint32_t dst = sbase + L.skip_off + ts * L.skip_tile;
          if (job.bulk) {
            mbar_expect_tx(skip_full + 8 * ts, n_rows * job.o * 2);
            bulk_load(dst, skip + (size_t)r0 * job.o, n_rows * job.o * 2, skip_full + 8 * ts);
          } else {
            mbar_expect_tx(skip_full + 8 * ts, TM * TN * 2);
            tma_load(dst, &tm_skip, skip_full + 8 * ts, n0, r0);
          }
          ts ^= 1;
          tph ^= ts == 0;
        }
        if (job.bulk) {  // the tile's rows of x and its images' gates, whole
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t st = sbase + L.w_res + s * L.stage;
          const int n_imgs = min(job.g_imgs, job.b - img0);
          mbar_expect_tx(full + 8 * s, (n_rows + n_imgs) * pitch);
          bulk_load(st + L.x_off, x + (size_t)r0 * job.m, n_rows * pitch, full + 8 * s);
          bulk_load(st + L.gate_off, gate + (size_t)img0 * job.m, n_imgs * pitch, full + 8 * s);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
          continue;
        }
        for (int kc = 0; kc < job.nk; ++kc) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t st = sbase + L.w_res + s * L.stage;
          mbar_expect_tx(full + 8 * s, stage_bytes);
          tma_load(st + L.x_off, &tm_x, full + 8 * s, kc * 64, r0);
          tma_load(st + L.gate_off, &tm_gate, full + 8 * s, kc * 64, img0);
          if (!job.resident)
            for (int bi = 0; bi < NB; ++bi)
              tma_load(st + L.w_off + bi * kBox, &tm_w, full + 8 * s, n0 + bi * 64, kc * 64);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warp `warp` owns rows [16 MT warp, 16 MT (warp + 1)) of a tile
  const int g = lane >> 2, tq = lane & 3;
  bf16* ostage = reinterpret_cast<bf16*>(base + L.out_off) + warp * 16 * MT * kOutPitch;
  bf16* dense = reinterpret_cast<bf16*>(base + L.dense_off) + warp * 16 * MT * TN;
  if (job.resident) mbar_wait(wbar, 0);
  int s = 0, ph = 0, ts = 0, tph = 0;
  for (int t = blockIdx.x; t < job.n_tiles; t += gridDim.x) {
    const int rt = t / job.n_ct, ct = t - rt * job.n_ct;
    const int r0 = rt * TM, n0 = ct * TN;
    const int img0 = r0 / job.hw;
    // each of this thread's rows' gate row (rows past the end are clamped:
    // their outputs are not stored), in bytes from the gate's start
    const int grow_pitch = job.bulk ? pitch : 128;
    int grow[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + warp * 16 * MT + mt * 16 + g + 8 * h;
        grow[mt][h] = min(row / job.hw - img0, job.g_imgs - 1) * grow_pitch + tq * 4;
      }

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;

    const int n_chunks = job.bulk ? 1 : job.nk;
    for (int kc = 0; kc < n_chunks; ++kc) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t xs = sbase + L.w_res + s * L.stage + L.x_off;
      const unsigned char* gs = base + L.w_res + s * L.stage + L.gate_off;
      if (job.bulk) {
        // x rows of `pitch` bytes, unswizzled; W resident: k16 step ks is
        // row (ks % 4) 16 of box group ks / 4
        const int ksteps = (job.m + 15) / 16;
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a_addr[MT];
          const unsigned char* gp[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int row = warp * 16 * MT + mt * 16 + (lane & 15);
            a_addr[mt] = xs + row * pitch + (ks * 2 + (lane >> 4)) * 16;
            gp[mt][0] = gs + grow[mt][0] + ks * 32;
            gp[mt][1] = gs + grow[mt][1] + ks * 32;
          }
          const int k = ks * 16 + 2 * tq;
          k16_step<MT, NT>(acc, sbase + (ks >> 2) * NB * kBox, ks & 3, a_addr, gp, k < job.m,
                           k + 8 < job.m, lane);
        }
      } else {
        // x in a 64 x 64 box (128-byte rows swizzled by row % 8)
        const uint32_t ws = job.resident ? sbase + kc * NB * kBox : sbase + L.w_res + s * L.stage + L.w_off;
        const int ksteps = min(4, (job.m - kc * 64 + 15) / 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < ksteps) {
            uint32_t a_addr[MT];
            const unsigned char* gp[MT][2];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int row = warp * 16 * MT + mt * 16 + (lane & 15);
              const int chunk = kk * 2 + (lane >> 4);
              a_addr[mt] = xs + row * 128 + ((chunk ^ (row & 7)) << 4);
              gp[mt][0] = gs + grow[mt][0] + kk * 32;
              gp[mt][1] = gs + grow[mt][1] + kk * 32;
            }
            k16_step<MT, NT>(acc, ws, kk, a_addr, gp, true, true, lane);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }

    // epilogue: bf16(acc + bias) staged per warp, then 16-byte rows (with
    // the skip added) to global memory, or (bulk) to dense rows that one
    // bulk store writes; accumulator (mt, nt, j): row mt*16 + g + 8 (j / 2),
    // column nt*8 + 2 tq + j % 2
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8 + 2 * tq;  // O % 8 == 0: col < o implies col + 1 < o
      const float2 bv = col < job.o ? __ldg(reinterpret_cast<const float2*>(bias + col))
                                    : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(ostage + (mt * 16 + g + 8 * h) * kOutPitch + nt * 8 +
                                             2 * tq) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h] + bv.x, acc[mt][nt][2 * h + 1] + bv.y);
    }
    if (job.bulk && lane == 0) bulk_wait_read();  // the last tile's store has read `dense`
    __syncwarp();
    const bf16* sk = nullptr;
    if (job.has_skip) {
      mbar_wait(skip_full + 8 * ts, tph);
      sk = reinterpret_cast<const bf16*>(base + L.skip_off + ts * L.skip_tile) +
           warp * 16 * MT * TN;
    }
    const int row0 = r0 + warp * 16 * MT;
    for (int v = lane; v < 16 * MT * NT; v += 32) {
      const int r = v / NT, cv = v - r * NT;
      const int row = row0 + r, col = n0 + cv * 8;
      if (row < job.rows && col < job.o) {
        uint4 val = *reinterpret_cast<const uint4*>(ostage + r * kOutPitch + cv * 8);
        if (sk != nullptr) {
          const uint4 sv = *reinterpret_cast<const uint4*>(sk + r * TN + cv * 8);
          __nv_bfloat162* vp = reinterpret_cast<__nv_bfloat162*>(&val);
          const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(vp[e]), b = __bfloat1622float2(sp[e]);
            vp[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
          }
        }
        if (job.bulk)
          *reinterpret_cast<uint4*>(dense + v * 8) = val;
        else
          *reinterpret_cast<uint4*>(out + (size_t)row * job.o + col) = val;
      }
    }
    if (job.bulk) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      const int n_rows = min(16 * MT, job.rows - row0);
      if (lane == 0 && n_rows > 0)
        bulk_store(out + (size_t)row0 * job.o, smem_u32(dense), n_rows * job.o * 2);
    }
    __syncwarp();  // the staging is refilled next tile
    if (job.has_skip) {
      if (lane == 0) mbar_arrive(skip_empty + 8 * ts);
      ts ^= 1;
      tph ^= ts == 0;
    }
  }
  if (job.bulk && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiled>(ptr);
  return fn;
}

// a (rows, cols) row-major bf16 tensor read in (box_rows, box_cols) boxes;
// elements past its ends read as zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows, int box_cols, bool swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT, int NT>
int launch(const CUtensorMap* maps, const void* const* ptrs, const Job& job, int grid,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        se_project_kernel<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  se_project_kernel<MT, NT><<<grid, kThreads, layout(MT, NT, job).total, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const bf16*)ptrs[0], (const bf16*)ptrs[1],
      (const bf16*)ptrs[2], (const float*)ptrs[3], (bf16*)ptrs[4], job);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, M) bf16 with rows = B * hw, gate (B, M) bf16, w (M, O) bf16, bias
// (O,) fp32, skip (rows, O) bf16 or null, out (rows, O) bf16; all contiguous
// and 16-byte aligned, M % 8 == 0, O % 8 == 0. The plan is
// kernels/se_project.py::se_plan's: nt (column tile 8 nt: 1-6, 8, 10, 12,
// 16 or 20), n_ct column tiles (n_ct 8 nt >= O), mt (64-row units of a row
// tile: 2 where nt <= 16, else 1), resident (W kept in shared memory: one
// column tile and at most 96 KB), bulk (the bulk route: resident W, 8 nt ==
// O), stages and grid (the blocks to launch).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take or tensor maps cuTensorMapEncodeTiled
// refuses.
extern "C" int objcavit_se_project(const void* x, const void* gate, const void* w,
                                   const void* bias, const void* skip, void* out, int rows, int hw,
                                   int m, int o, int b, int nt, int n_ct, int mt, int resident,
                                   int bulk, int stages, int grid, void* stream) {
  if (rows == 0 || o == 0) return (int)cudaSuccess;
  if (rows < 0 || hw <= 0 || b <= 0 || rows != b * hw || m <= 0 || m % 8 || o <= 0 || o % 8 ||
      n_ct <= 0 || n_ct * 8 * nt < o || stages < 1 || grid <= 0 || (mt != 1 && mt != 2))
    return (int)cudaErrorInvalidValue;
  Job job;
  job.rows = rows;
  job.hw = hw;
  job.m = m;
  job.o = o;
  job.b = b;
  job.nk = (m + 63) / 64;
  job.n_ct = n_ct;
  job.n_tiles = (rows + 64 * mt - 1) / (64 * mt) * n_ct;
  const int span = (64 * mt - 1 + hw - 1) / hw + 1;  // images 64 mt rows may touch
  job.g_imgs = span < b ? span : b;
  job.stages = stages;
  job.resident = resident;
  job.has_skip = skip != nullptr;
  job.bulk = bulk;
  const int nb = (8 * nt + 63) / 64;
  if (job.g_imgs > 256 || (resident && (n_ct != 1 || job.nk * nb * kBox > kMaxResident)) ||
      (bulk && (!resident || 8 * nt != o)) ||
      layout(mt, nt, job).total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_fn();
  if (!encode) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4] = {};
  if (!make_map(encode, &maps[0], x, rows, m, 64 * mt, 64, true) ||
      !make_map(encode, &maps[1], w, m, o, 64, 64, true) ||
      !make_map(encode, &maps[2], gate, b, m, job.g_imgs, 64, false) ||
      (skip != nullptr && !make_map(encode, &maps[3], skip, rows, o, 64 * mt, 8 * nt, false)))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[5] = {x, gate, skip, bias, out};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mt * 100 + nt) {
    case 201: return launch<2, 1>(maps, ptrs, job, grid, s);
    case 202: return launch<2, 2>(maps, ptrs, job, grid, s);
    case 203: return launch<2, 3>(maps, ptrs, job, grid, s);
    case 204: return launch<2, 4>(maps, ptrs, job, grid, s);
    case 205: return launch<2, 5>(maps, ptrs, job, grid, s);
    case 206: return launch<2, 6>(maps, ptrs, job, grid, s);
    case 208: return launch<2, 8>(maps, ptrs, job, grid, s);
    case 210: return launch<2, 10>(maps, ptrs, job, grid, s);
    case 212: return launch<2, 12>(maps, ptrs, job, grid, s);
    case 216: return launch<2, 16>(maps, ptrs, job, grid, s);
    case 120: return launch<1, 20>(maps, ptrs, job, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
