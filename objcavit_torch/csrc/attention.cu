// Fused multi-head attention, forward and backward (kernel 5).
//
// Replaces the TPU kernels objcavit_tpu/ops/pallas_attention.py::
// _attn_fwd_impl (_fwd_kernel) and ::_attn_bwd (_bwd_kernel), the custom VJP
// behind mha_core(impl="pallas") that every transformer of the repository
// runs on its attention-kernel route:
//
//   s      = q k^T * scale + bias[key]        (bias 0, or -1e30 where masked)
//   w      = softmax_keys(s)                  (fp32)
//   o      = w v                              (fp32 weights, one cast at the end)
//   dv     = w^T g
//   ds     = w * (g v^T - rowsum(g v^T * w))
//   dq     = ds k * scale,   dk = ds^T q * scale
//
// q (B, Sq, H, 32), k and v (B, Sk, H, 32) bf16, read in place through their
// batch, token and head strides (the chunked in_proj output needs no
// transpose); o, g, dq, dk, dv contiguous (B, S, H, 32) bf16; bias (B, Sk)
// fp32 or null.
//
// What bounds it on the H100: at the flagship's (B*H = 32, S = 300, D = 32)
// one forward moves 2.46 MB of q, k, v and o and 0.08 MB of the bias and the
// residual (0.76 us at 3.35 TB/s) and does 0.37 GFLOP (0.37 us at 989
// TFLOP/s): bound by bytes, and at these sizes in practice by latency and
// launch overhead. The backward reads q, k, v, g, the bias and the residual
// and writes dq, dk, dv, 4.39 MB, and does five such products (1.31 us and
// 0.93 us).
//
// At the long routes' shapes (B*H = 32, S 1200 served, S 884 trained) the
// bound is operations, and not the tensor cores': the forward's 46.08 M
// scores at S 1200 are 46.08 M exps, 0.011 ms on the SFU alone (16 ex2 a
// clock an SM at 1.98 GHz), against 0.006 ms of products at 989 TFLOP/s,
// and each score also costs some six fp32 instructions (scale, max,
// subtract, sum, the hi/lo split). The backward's 25.0 M scores at S 884 are
// exps and elementwise work once for every time a route computes P.
//
// Design. The TPU kernel keeps a whole (Sq, Sk) score tile of one (b, h) in
// VMEM; here the scores never leave registers. Flash-style, in tiles of 64
// keys, products on the tensor cores in bf16 with fp32 accumulators; the
// softmax is online in fp32 (running row max and sum). The weights enter
// the w v product split in two bf16 terms, hi = bf16(w) and lo = bf16(w -
// hi), so they keep ~16 bits, not 8: the TPU kernel multiplies fp32
// weights. The same split carries ds and w into the backward's products.
// Up to 512 keys and queries the products are mma.sync m16n8k16; beyond,
// wgmma (the long routes, below).
//
// Forward, up to 512 keys (every model shape): a block takes R m-tiles of
// 16 query rows of one (b, h) and holds the head's whole K, V and bias in
// shared memory (38 KB at S 300). It issues every copy up front (cp.async,
// one group a key tile), so no key tile waits on a load once its copies
// have landed; the first version walked the key tiles in series with a
// one-tile prefetch and waited out most of a load's latency each tile. G
// key groups of R warps each take a share of the key tiles for the same
// rows, so a warp's chain is at most ceil(n / G) tiles (5 before, 2 now at
// S 300), and groups 1.. hand their running max, sums and accumulators to
// group 0 through shared memory. fwd_plan picks R so the B*H heads' blocks
// fill the card once (at (32 heads, S 300) on 132 SMs: R = 5, 128 blocks;
// 64-row blocks made 160, 28 SMs ran two) and G as 16 warps allow
// (kernels/attention.py::fwd_plan, passed in by the wrapper). Where no
// backward reads the residual (the wrapper passes a null stats pointer: no
// grad, or no input needing it), it is not written.
//
// Hazards. Keys past Sk in the last tile get -inf, so they weigh exactly 0;
// a masked key gets -1e30, so a row whose keys are all masked is uniform
// over its Sk real keys, as in the TPU kernel. The forward's residual for
// the backward is each row's max m and log-sum L = log sum exp(s - m), kept
// apart: their sum, the log-sum-exp, rounds to -1e30 on a fully masked row
// and would lose the 1/Sk.
//
// Backward, no atomics, so the result does not depend on timing. D is the
// row term rowsum(dP * P) (dP = g v^T; the TPU kernel's rowsum(dw * w)). Two
// routes, chosen by shape in the entry point:
//
// Cluster route (Sq <= 512 and Sk <= 512; the models' shapes). One launch,
// one thread-block cluster per (b, h) of n = ceil(Sk / 64) <= 8 blocks (the
// portable cluster size); block r owns key tile r and holds the head's whole
// Q and G, its own K_r and V_r, and every row's m and L in shared memory.
// Eight warps: warp w takes the 16 keys 16 (w % 4) of the tile and every
// second 16-query m-tile (w / 4 picks which), with K and V as the A operand,
// so P^T and dP^T come out key-major and feed dv += P^T g and dk += dS^T q
// straight from the accumulators. Phase 1 computes P and dP of each (m-tile,
// key tile) pair and sums D over the block's keys (warp shuffles, then the
// four key warps in order); after a cluster barrier each block sums the n blocks'
// partial D in rank order over distributed shared memory, so every block
// holds the same D. Phase 2 recomputes P and dP once, forms dS = P (dP - D),
// accumulates dk and dv, and hands dS^T (hi and lo bf16 terms) through
// shared memory to the four warps of its query group, which multiply it by
// K_r (each 8 of the 32 columns) into the block's partial dq (fp32), kept
// where that m-tile's Q and G rows were: nothing reads them any more. The
// two query groups' dk and dv are added in order and written; after a
// second cluster barrier block r sums query tiles r, r + n, ... of the n
// partial dq in rank order, scales and writes them. At the flagship's
// (B*H = 32, S = 300) that is 160 blocks of 84 KB of shared memory, two to
// an SM, each computing P and dP of its 19 m-tiles twice: 4 score-sized
// products where the two-kernel route takes 6, and no grid-wide dependency.
//
// Long routes (Sq or Sk above 512, up to 8192: under do_final_upscale every
// attention, S 1200 served against up to 1000 object slots, S 884 trained).
// The first versions lost to SDPA (0.0645 ms against 0.0462 forward at
// S 1200, 0.153 against 0.059 backward at S 884 on the H100): one warp
// walked all 19 key tiles of its 16 rows in series, every tile cost two
// block-wide barriers on a two-stage cp.async ring, mma.sync fed each
// product from shared memory by per-thread loads, and the backward
// computed every score's P three times (a pass for D, one for dq, one for
// dk and dv) in two launches in series. Now:
//
// * Warpgroups on wgmma. Every product is wgmma with the A operand in
//   registers and B a 64 x 32 tile in shared memory in the 64-byte swizzle,
//   the layout one TMA box of a head's 64 rows writes: S = Q K^T and dP =
//   G V^T (and their transposes in the key-tile blocks) as m64n64k16 with
//   Q, G, K or V fragments loaded once, the tile read as B^T; O += P V, dv
//   += P^T g, dk += dS^T q and dq += dS k as m64n32k16 with P or dS as hi
//   and lo terms straight from the score accumulators, the tile read as B
//   (MN-major). Unswizzled tiles (four 8-column boxes) ran 1.5x slower, the
//   32-column products on mma.sync 6-10% slower (PERF.md §6).
// * A ring instead of block barriers. Each warpgroup streams its tiles by
//   TMA (4-D tensor maps encoded on the host each call, on the strided
//   views as they are; rows past S zero-filled) through a ring of 4 stages
//   on mbarriers, which its first warp refills once the warpgroup's four
//   warps have passed a named barrier after their last product on a stage.
//   No block-wide barrier runs per tile. The wrapper's input check (16-byte
//   aligned, unit stride in D, every other stride a multiple of 8 elements)
//   makes every map encodable; where one still fails to encode, the launch
//   returns cudaErrorInvalidValue, as kernels 2, 6 and 7 do, and never
//   falls back to another route or copy path.
// * One FFMA a score before the exp: x = s scale log2(e) + bias log2(e),
//   then ex2(x - m); with no bias on a tile (S 1200 served has no mask) the
//   max is taken on s and the scale folds into the exp's FFMA. The hi/lo
//   split of P and dS truncates hi (a byte permute) and rounds lo: one
//   conversion a pair, ~16 bits (split2_trunc).
// * Forward: a block is G warpgroups (key groups, as the resident forward's)
//   over the same 64 query rows, each over ceil(n / G) key tiles, merged
//   through shared memory at the end. long_fwd_plan picks G from the SM's
//   occupancy (four one-group blocks, two of two, one of three at 128
//   registers) so the waves fill 132 SMs: G = 2 at S 1200, 1 at S 884.
// * Backward: D = rowsum(dP * P) summed over the key tiles by a launch of
//   query-tile blocks (the TPU kernel's row term). Then one launch of two
//   kinds of one-warpgroup blocks, the key tiles' first: a key tile's block
//   keeps dk and dv in registers over every query tile; a query tile's
//   block keeps dq over every key tile. Each score's P and dP are computed
//   three times, as in the first versions; each block sums in a fixed order and
//   no block waits on another. D = rowsum(g o) from an fp32 output kept in
//   the residual saved the first launch but missed the checks where dq
//   cancels as a whole (GraphBins' final-upscale step: PERF.md §6).
//
// What bounds them now: neither the exps nor the tensor cores alone. Taking
// out the exps, the P V products or the hi/lo split each saved 10-20% of
// the forward's time on the H100; issuing the next tile's S ahead of the
// softmax cost a warpgroup of occupancy and ran slower. The backward's N =
// 32 products, with their split, take two thirds of its main launch: it
// does 12 score-sized products a score where the bound counts 5.
//
// The residual of the long routes is the max and log-sum in log2 units: a
// fully masked row's max rounds the same way in both directions, so its x
// - m is 0 there and P is 1 / Sk.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"  // smem_addr, the mbarrier and TMA helpers, the tensor-map encoder

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 32;       // head dimension
constexpr int kTile = 64;    // rows of a block's tile: queries, or keys
constexpr int kLd = kD + 8;  // shared row stride (bf16): 80 bytes, conflict-free fragments

struct Strides {
  long long b, s, h;  // element strides of a (B, S, H, D) view; D is unit-stride
};

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 bf16 matrices, transposed: the B fragments of a row-major [k][n] tile
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed low half first
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// A fragments (hi and lo) of k-step kk from the accumulators of the n-tiles
// 2kk and 2kk + 1 of a 16 x 8NT product: the accumulator layout of two
// neighbouring m16n8 tiles is the A layout of one m16k16 step
template <int NT>
__device__ __forceinline__ void acc_to_a(const float (&c)[NT][4], int kk, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split2(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split2(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// acc (16 x 32) += A (16 x 8NT, as hi + lo) @ Y (8NT x 32 row-major in shared)
template <int NT>
__device__ __forceinline__ void mma_split_by_tile(float (&acc)[4][4], const float (&a)[NT][4],
                                                  const __nv_bfloat16* y, int lane) {
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    acc_to_a(a, kk, hi, lo);
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, y + (kk * 16 + (j & 1) * 8 + r) * kLd + np * 16 + (j >> 1) * 8);
      mma16816(acc[2 * np], hi, b[0], b[1]);
      mma16816(acc[2 * np], lo, b[0], b[1]);
      mma16816(acc[2 * np + 1], hi, b[2], b[3]);
      mma16816(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// out (16 x 64) = A (16 x 32, fragments in registers) @ Y^T, Y (64 x 32) row-major in shared
__device__ __forceinline__ void mma_by_tile_t(float (&out)[8][4], const uint32_t (&a)[2][4],
                                              const __nv_bfloat16* y, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    out[nt][0] = out[nt][1] = out[nt][2] = out[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      const __nv_bfloat16* p = y + (nt * 8 + g) * kLd + ks * 16 + 2 * t;
      mma16816(out[nt], a[ks], lds32(p), lds32(p + 8));
    }
  }
}

// A fragments of a warp's 16 rows (row0 = its first) of a 64 x 32 shared tile
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const __nv_bfloat16* x, int row0,
                                       int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const __nv_bfloat16* p = x + (row0 + g) * kLd + ks * 16 + 2 * t;
    a[ks][0] = lds32(p);
    a[ks][1] = lds32(p + 8 * kLd);
    a[ks][2] = lds32(p + 8);
    a[ks][3] = lds32(p + 8 * kLd + 8);
  }
}

// rows [row0, row0 + rows) of one head (base points at its row 0) -> shared,
// 16 bytes a copy by a block of THREADS threads; rows past n_rows are zero-filled
template <int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int rows, int n_rows) {
  for (int c = threadIdx.x; c < rows * (kD / 8); c += THREADS) {
    const int r = c / (kD / 8), part = c % (kD / 8);
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* src = base + (valid ? (long long)(row0 + r) * row_stride : 0) + part * 8;
    cp_async16(dst + r * kLd + part * 8, src, valid);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// store a 16 x 32 fp32 fragment (times mul) as bf16 rows of a contiguous
// (B, S, H, 32) tensor; out_head points at (b, row 0, h), rows past n_rows skipped
__device__ __forceinline__ void store_rows(__nv_bfloat16* out_head, long long row_stride,
                                           const float (&acc)[4][4], int row, int n_rows,
                                           float mul0, float mul1, int t) {
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out_head + row * row_stride + col) =
          __floats2bfloat162_rn(acc[nd][0] * mul0, acc[nd][1] * mul0);
    if (row + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out_head + (row + 8) * row_stride + col) =
          __floats2bfloat162_rn(acc[nd][2] * mul1, acc[nd][3] * mul1);
  }
}

// One 64-key tile for a warp's 16 query rows (A fragments qa): the scores
// q k^T * scale + bias, the online softmax (running max m_run, this lane's
// share of the running sum l_run) and acc += w v, the weights as hi + lo.
// K and V are 64 x 32 row-major tiles in shared memory.
__device__ __forceinline__ void fwd_tile(const uint32_t (&qa)[2][4], const __nv_bfloat16* k_tile,
                                         const __nv_bfloat16* v_tile, const float* bias_tile,
                                         float scale, float (&m_run)[2], float (&l_run)[2],
                                         float (&acc)[4][4], int lane, int g, int t) {
  float s[8][4];
  mma_by_tile_t(s, qa, k_tile, g, t);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = s[nt][j] * scale + bias_tile[nt * 8 + 2 * t + (j & 1)];
      s[nt][j] = x;
      mx[j >> 1] = fmaxf(mx[j >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every tile holds a real key, so the new max is finite
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
    alpha[r] = __expf(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int nd = 0; nd < 4; ++nd) {
    acc[nd][0] *= alpha[0];
    acc[nd][1] *= alpha[0];
    acc[nd][2] *= alpha[1];
    acc[nd][3] *= alpha[1];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = __expf(s[nt][j] - m_run[j >> 1]);
      s[nt][j] = p;
      l_run[j >> 1] += p;
    }
  mma_split_by_tile(acc, s, v_tile, lane);
}

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;  // (B, Sk) or null
  Strides sq, sk, sv;
  int h, s_q, s_k;
  float scale;
};

// ---------------------------------------------- forward, keys resident

constexpr int kMaxFWarps = 16;
constexpr int kResMaxTiles = 8;  // keys a head holds in shared memory: 512
constexpr int kMaxKeyGroups = 4;
constexpr int kMergeVals = 20;   // a thread's 16 accumulators, 2 maxima, 2 sums

// A block of the resident forward: `rows` m-tiles of 16 query rows of one
// (b, h), each taken by one warp of every one of `groups` key groups. The
// wrapper picks it (kernels/attention.py::fwd_plan).
struct FwdPlan {
  int rows, groups;
};

// Byte offsets of the resident forward's shared memory: Q (16 rows an
// m-tile), the head's K and V (n tiles each), the bias of every key, and
// the states of key groups 1.. for the merge (value-major, so a warp's
// stores hit distinct banks)
struct FwdSmem {
  int k, v, bias, merge, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int n_kt, int rows, int groups) {
  FwdSmem s;
  s.k = 16 * rows * kLd * 2;
  s.v = s.k + n_kt * kTile * kLd * 2;
  s.bias = s.v + n_kt * kTile * kLd * 2;
  s.merge = s.bias + n_kt * kTile * 4;
  s.total = s.merge + (groups - 1) * kMergeVals * 32 * rows * 4;
  return s;
}

// the most any plan takes: 8 key tiles, Q of 8 m-tiles, 12 warps' states
constexpr int kFwdSmemMax = 16 * 8 * kLd * 2 + 2 * kResMaxTiles * kTile * kLd * 2 +
                            kResMaxTiles * kTile * 4 + 12 * kMergeVals * 32 * 4;

// key group g's tiles of n among G: [first(g), first(g + 1)); group 0
// always holds tile 0, and no group more than ceil(n / G)
__device__ __forceinline__ int group_first_tile(int g, int n_kt, int groups) {
  return (n_kt * g + groups - 1) / groups;
}

// rows [row0, row0 + rows) of one head -> shared by `nthreads` threads of
// which this is `tid`, 16 bytes a copy; rows past n_rows are zero-filled
__device__ __forceinline__ void load_rows_by(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                             long long row_stride, int row0, int rows, int n_rows,
                                             int tid, int nthreads) {
  for (int c = tid; c < rows * (kD / 8); c += nthreads) {
    const int r = c / (kD / 8), part = c % (kD / 8);
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* src = base + (valid ? (long long)(row0 + r) * row_stride : 0) + part * 8;
    cp_async16(dst + r * kLd + part * 8, src, valid);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// wait until at most n of this thread's cp.async groups are pending; n is
// at most a group's key tiles, kResMaxTiles (one key group over 8 tiles)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  static_assert(kResMaxTiles == 8, "cp_async_wait_upto covers n up to 8");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// grid (ceil(Sq / (16 plan.rows)), B * H) of 32 plan.rows plan.groups
// threads, Sk <= 512. A block takes 16 plan.rows query rows of one (b, h)
// and holds the head's whole K, V and bias: every copy is issued up front, one cp.async group a
// key tile, so no tile waits on a load once its copies have landed. Key
// group k's warps take every query row of the block over its share of the
// key tiles (group_first_tile); groups 1.. hand their running max, sums and
// accumulators to group 0 through shared memory, which merges them and
// writes o, and the residual when stats is not null.
__global__ void __launch_bounds__(kMaxFWarps * 32)
attn_fwd_resident_kernel(Args a, FwdPlan plan, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char fsm[];
  const int n_kt = (a.s_k + kTile - 1) / kTile;
  const FwdSmem off = fwd_smem(n_kt, plan.rows, plan.groups);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fsm);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(fsm + off.k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(fsm + off.v);
  float* bias_s = reinterpret_cast<float*>(fsm + off.bias);
  float* merge_s = reinterpret_cast<float*>(fsm + off.merge);

  const int gsize = 32 * plan.rows;  // threads of a key group
  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  const int q0 = blockIdx.x * 16 * plan.rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int grp = warp / plan.rows, mt = warp - grp * plan.rows;  // key group, m-tile
  const int gt = threadIdx.x - grp * gsize;                         // thread within the group
  const int t0 = group_first_tile(grp, n_kt, plan.groups);
  const int t1 = group_first_tile(grp + 1, n_kt, plan.groups);
  const int most = (n_kt + plan.groups - 1) / plan.groups;  // tiles of the largest group
  const __nv_bfloat16* qb = a.q + b * a.sq.b + hh * a.sq.h;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hh * a.sv.h;
  const float* biasb = a.bias ? a.bias + (size_t)b * a.s_k : nullptr;

  // Q and every key's bias (keys past Sk get -inf), then each group's K and
  // V tiles, one commit group a tile, padded to `most` groups in all
  load_rows_by(q_s, qb, a.sq.s, q0, 16 * plan.rows, a.s_q, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < n_kt * kTile; i += blockDim.x) {
    if (i < a.s_k && biasb)
      cp_async4(bias_s + i, biasb + i);
    else
      bias_s[i] = i < a.s_k ? 0.f : -INFINITY;
  }
  cp_async_commit();
  for (int j = 0; j < most; ++j) {
    const int kt = t0 + j;
    if (kt < t1) {
      load_rows_by(k_s + kt * kTile * kLd, kb, a.sk.s, kt * kTile, kTile, a.s_k, gt, gsize);
      load_rows_by(v_s + kt * kTile * kLd, vb, a.sv.s, kt * kTile, kTile, a.s_k, gt, gsize);
    }
    cp_async_commit();
  }
  cp_async_wait_upto(most);  // this thread's share of Q and the bias
  __syncthreads();           // everyone's

  uint32_t qa[2][4];
  load_a(qa, q_s, mt * 16, g, t);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[4][4];
#pragma unroll
  for (int nd = 0; nd < 4; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  for (int j = 0; t0 + j < t1; ++j) {
    cp_async_wait_upto(most - 1 - j);
    // the group's copies of its tile j
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(gsize) : "memory");
    const int kt = t0 + j;
    fwd_tile(qa, k_s + kt * kTile * kLd, v_s + kt * kTile * kLd, bias_s + kt * kTile, a.scale,
             m_run, l_run, acc, lane, g, t);
  }

  // groups 1..'s states (a max of -inf and zero sums where a group took no tile)
  if (grp > 0) {
    float* mine = merge_s + (grp - 1) * kMergeVals * gsize + gt;
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int j = 0; j < 4; ++j) mine[(nd * 4 + j) * gsize] = acc[nd][j];
    mine[16 * gsize] = m_run[0];
    mine[17 * gsize] = m_run[1];
    mine[18 * gsize] = l_run[0];
    mine[19 * gsize] = l_run[1];
  }
  __syncthreads();
  if (grp > 0) return;
  for (int other_g = 1; other_g < plan.groups; ++other_g) {
    const float* other = merge_s + (other_g - 1) * kMergeVals * gsize + gt;
    float alpha[2], beta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mb = other[(16 + r) * gsize];
      const float m = fmaxf(m_run[r], mb);  // group 0's max is finite: tile 0 holds key 0
      alpha[r] = __expf(m_run[r] - m);
      beta[r] = __expf(mb - m);
      l_run[r] = l_run[r] * alpha[r] + other[(18 + r) * gsize] * beta[r];
      m_run[r] = m;
    }
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[nd][j] = acc[nd][j] * alpha[j >> 1] + other[(nd * 4 + j) * gsize] * beta[j >> 1];
  }

  const int row = q0 + mt * 16 + g;
  const float l0 = quad_sum(l_run[0]), l1 = quad_sum(l_run[1]);
  const long long ld_o = (long long)a.h * kD;
  store_rows(o + ((size_t)b * a.s_q * a.h + hh) * kD, ld_o, acc, row, a.s_q, 1.f / l0, 1.f / l1,
             t);
  if (t == 0 && stats) {
    const size_t n = (size_t)gridDim.y * a.s_q;
    float* m_out = stats + (size_t)bh * a.s_q;
    if (row < a.s_q) m_out[row] = m_run[0], m_out[n + row] = logf(l0);
    if (row + 8 < a.s_q) m_out[row + 8] = m_run[1], m_out[n + row + 8] = logf(l1);
  }
}

// ------------------------------------------------------------ cluster route

constexpr int kCWarps = 8;  // 4 key warps (16 keys each) x 2 query groups
constexpr int kCThreads = kCWarps * 32;
constexpr int kGroupThreads = 4 * 32;
constexpr int kMaxClusterTiles = 8;  // the portable cluster size
constexpr int kClusterMaxS = kMaxClusterTiles * kTile;

// Shared memory of the cluster kernel, for Sq padded to sq_p (a multiple
// of 16): the head's Q and G in chunks of one 16-query m-tile (its 16 Q
// rows, then its 16 G rows); once phase 2 is done with an m-tile, its chunk
// holds the block's partial dq of those 16 queries (fp32, swizzled). Then
// K_r, V_r, the dS^T buffers (two a query group, in turns), each row's m,
// L, D and the block's partial D, and the tile's bias. Byte offsets:
constexpr int kChunk = 2 * 16 * kLd;  // bf16 elements of an m-tile's chunk

struct BwdSmem {
  int k, v, ds, m, l, d, dr, bias, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int sq_p) {
  BwdSmem s;
  s.k = sq_p / 16 * kChunk * 2;
  s.v = s.k + kTile * kLd * 2;
  s.ds = s.v + kTile * kLd * 2;  // also phase 1's per-warp D and the end's dk, dv sums
  s.m = s.ds + 4 * kTile * kLd * 2;
  s.l = s.m + sq_p * 4;
  s.d = s.l + sq_p * 4;
  s.dr = s.d + sq_p * 4;
  s.bias = s.dr + sq_p * 4;
  s.total = s.bias + kTile * 4;
  return s;
}

// a cluster barrier in two halves, so work that needs no other block runs
// between them: arrive (releasing this thread's shared-memory writes to the
// cluster), then wait (acquiring the others'). A relaxed arrive releases
// nothing: it only says this thread's reads of other blocks are done
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kGroupThreads) : "memory");
}

// element (row, col) of a 16 x 32 partial dq: columns XOR-swizzled by row so
// a warp's fragment stores hit distinct banks; groups of 4 columns stay whole
__device__ __forceinline__ int dq_index(int row, int col) {
  return row * kD + (col ^ ((row & 3) << 3));
}

// grid (n, B * H), clusters of (n, 1, 1), n = ceil(Sk / 64) <= 8
__global__ void __launch_bounds__(kCThreads, 2)
attn_bwd_cluster_kernel(Args a, const __nv_bfloat16* __restrict__ gout,
                        const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = gridDim.x, rank = (int)cluster.block_rank();  // the cluster spans x
  const int sq_p = (a.s_q + 15) & ~15, n_mt = sq_p / 16;
  const BwdSmem off = bwd_smem(sq_p);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + off.k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + off.v);
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem + off.ds);
  float* m_s = reinterpret_cast<float*>(smem + off.m);
  float* l_s = reinterpret_cast<float*>(smem + off.l);
  float* d_s = reinterpret_cast<float*>(smem + off.d);
  float* dr_s = reinterpret_cast<float*>(smem + off.dr);
  float* bias_s = reinterpret_cast<float*>(smem + off.bias);

  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  const int k0 = rank * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int kw = warp & 3, group = warp >> 2;
  const long long ld = (long long)a.h * kD;  // token stride of g, dq, dk and dv
  const __nv_bfloat16* qb = a.q + b * a.sq.b + hh * a.sq.h;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hh * a.sv.h;
  const __nv_bfloat16* gb = gout + ((size_t)b * a.s_q * a.h + hh) * kD;

  // Q and G rows of m-tiles [mt0, mt1) into their chunks; rows past Sq zero-filled
  auto load_chunks = [&](int mt0, int mt1) {
    for (int c = 16 * mt0 * (kD / 8) + threadIdx.x; c < 16 * mt1 * (kD / 8); c += kCThreads) {
      const int r = c / (kD / 8), part = c % (kD / 8);
      const bool valid = r < a.s_q;
      __nv_bfloat16* dst = tiles + (r >> 4) * kChunk + (r & 15) * kLd + part * 8;
      cp_async16(dst, qb + (valid ? r * a.sq.s : 0) + part * 8, valid);
      cp_async16(dst + 16 * kLd, gb + (valid ? r * ld : 0) + part * 8, valid);
    }
  };
  // two groups of copies: phase 1 starts on the first half of the m-tiles
  // while the second is in flight
  const int half = (n_mt + 1) / 2;
  load_rows<kCThreads>(k_s, kb, a.sk.s, k0, kTile, a.s_k);
  load_rows<kCThreads>(v_s, vb, a.sv.s, k0, kTile, a.s_k);
  load_chunks(0, half);
  cp_async_commit();
  load_chunks(half, n_mt);
  cp_async_commit();
  const size_t n_rows_all = (size_t)gridDim.y * a.s_q;
  const float* m_in = stats + (size_t)bh * a.s_q;
  for (int i = threadIdx.x; i < sq_p; i += kCThreads) {
    const bool valid = i < a.s_q;
    // an m of +inf makes P = 0 for the rows past Sq
    m_s[i] = valid ? m_in[i] : INFINITY;
    l_s[i] = valid ? m_in[n_rows_all + i] : 0.f;
  }
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    bias_s[threadIdx.x] =
        key < a.s_k ? (a.bias ? a.bias[(size_t)b * a.s_k + key] : 0.f) : -INFINITY;
  }
  cp_async_wait<1>();
  __syncthreads();

  uint32_t ka[2][4], va[2][4];
  load_a(ka, k_s, 16 * kw, g, t);
  load_a(va, v_s, 16 * kw, g, t);
  const float bias_r[2] = {bias_s[16 * kw + g], bias_s[16 * kw + g + 8]};

  // P^T and dP^T (this warp's 16 keys x the 16 queries of m-tile mt):
  // S^T = K Q^T, P = exp((s * scale + bias - m) - L), dP^T = V G^T
  auto probs = [&](int mt, float (&p)[2][4], float (&dp)[2][4]) {
    const __nv_bfloat16* qt = tiles + mt * kChunk;
    const __nv_bfloat16* gt = qt + 16 * kLd;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const int at = (nt * 8 + g) * kLd + ks * 16 + 2 * t;
        mma16816(p[nt], ka[ks], lds32(qt + at), lds32(qt + at + 8));
        mma16816(dp[nt], va[ks], lds32(gt + at), lds32(gt + at + 8));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = 16 * mt + nt * 8 + 2 * t + (j & 1);
        const float x = p[nt][j] * a.scale + bias_r[j >> 1];
        p[nt][j] = __expf((x - m_s[qc]) - l_s[qc]);
      }
    }
  };

  // phase 1: each warp's sum of dP * P over its 16 keys, per query, for
  // its m-tiles in [mt0, mt1)
  float* dpart_s = reinterpret_cast<float*>(ds_s);  // [4][sq_p]
  auto row_terms = [&](int mt0, int mt1) {
#pragma unroll 2
    for (int mt = mt0 + ((group - mt0) & 1); mt < mt1; mt += 2) {
      float p[2][4], dp[2][4];
      probs(mt, p, dp);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float s = p[nt][c] * dp[nt][c] + p[nt][2 + c] * dp[nt][2 + c];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (g == 0) dpart_s[kw * sq_p + 16 * mt + nt * 8 + 2 * t + c] = s;
        }
    }
  };
  row_terms(0, half);
  cp_async_wait<0>();
  __syncthreads();
  row_terms(half, n_mt);
  __syncthreads();
  for (int i = threadIdx.x; i < sq_p; i += kCThreads)
    dr_s[i] = ((dpart_s[i] + dpart_s[sq_p + i]) + dpart_s[2 * sq_p + i]) + dpart_s[3 * sq_p + i];
  cluster_arrive();

  // phase 2's set-up while the other blocks finish phase 1: K_r's B
  // fragments for this warp's 8 columns of dq (4 k-steps), and the sums
  uint32_t kfrag[8];
#pragma unroll
  for (int pair = 0; pair < 2; ++pair) {
    uint32_t r4[4];
    ldsm_x4_trans(r4, k_s + (32 * pair + 8 * (lane >> 3) + (lane & 7)) * kLd + 8 * kw);
#pragma unroll
    for (int j = 0; j < 4; ++j) kfrag[4 * pair + j] = r4[j];
  }
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int nd = 0; nd < 4; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nd][j] = dv_acc[nd][j] = 0.f;

  cluster_wait();
  for (int i = threadIdx.x; i < sq_p; i += kCThreads) {
    float part[kMaxClusterTiles];  // all n loads in flight, then the sum in rank order
#pragma unroll
    for (int r = 0; r < kMaxClusterTiles; ++r)
      if (r < n) part[r] = r == rank ? dr_s[i] : cluster.map_shared_rank(dr_s, r)[i];
    float s = part[0];
#pragma unroll
    for (int r = 1; r < kMaxClusterTiles; ++r)
      if (r < n) s += part[r];
    d_s[i] = s;
  }
  __syncthreads();

  // phase 2
  for (int mt = group, turn = 0; mt < n_mt; mt += 2, turn ^= 1) {
    const __nv_bfloat16* qt = tiles + mt * kChunk;
    float p[2][4], dp[2][4];
    probs(mt, p, dp);
    mma_split_by_tile(dv_acc, p, qt + 16 * kLd, lane);  // dv += P^T g
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[nt][j] *= dp[nt][j] - d_s[16 * mt + nt * 8 + 2 * t + (j & 1)];
    mma_split_by_tile(dk_acc, p, qt, lane);  // dk += dS^T q
    // dS^T to shared, a row per key: hi terms in columns 0-15, lo in 16-31.
    // The group's buffers take m-tiles in turns: a warp writes one only
    // after the whole group passed the barrier that follows the last reads
    __nv_bfloat16* ds_buf = ds_s + (2 * group + turn) * kTile * kLd;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t hi, lo;
        split2(p[nt][2 * hf], p[nt][2 * hf + 1], hi, lo);
        __nv_bfloat16* row = ds_buf + (16 * kw + g + 8 * hf) * kLd + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(row) = hi;
        *reinterpret_cast<uint32_t*>(row + 16) = lo;
      }
    group_sync(group);  // dS^T is whole; the group is done with this m-tile's Q and G
    // the block's partial dq of these 16 queries, columns 8 kw .. 8 kw + 7:
    // dS (16 x 64 keys, transposed out of shared) times K_r, into the chunk
    // (hi and lo terms in two accumulators: two chains of 4 products)
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc_lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const int mat = lane >> 3;
      const __nv_bfloat16* src =
          ds_buf + (16 * kk + 8 * (mat >> 1) + (lane & 7)) * kLd + 8 * (mat & 1);
      uint32_t ah[4], al[4];
      ldsm_x4_trans(ah, src);
      ldsm_x4_trans(al, src + 16);
      mma16816(acc, ah, kfrag[2 * kk], kfrag[2 * kk + 1]);
      mma16816(acc_lo, al, kfrag[2 * kk], kfrag[2 * kk + 1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += acc_lo[j];
    float* dq_t = reinterpret_cast<float*>(tiles + mt * kChunk);
    const int col = 8 * kw + 2 * t;
    *reinterpret_cast<float2*>(dq_t + dq_index(g, col)) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(dq_t + dq_index(g + 8, col)) = make_float2(acc[2], acc[3]);
  }

  cluster_arrive();  // the partial dq is whole once every thread arrives

  // dk and dv: group 0's sums plus group 1's, in that order
  __syncthreads();  // the dS^T buffers are done with: group 1's sums go there
  float* red = reinterpret_cast<float*>(ds_s);
  const int gt = threadIdx.x % kGroupThreads;
  if (group == 1) {
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(nd * 4 + j) * kGroupThreads + gt] = dk_acc[nd][j];
        red[(16 + nd * 4 + j) * kGroupThreads + gt] = dv_acc[nd][j];
      }
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk_acc[nd][j] += red[(nd * 4 + j) * kGroupThreads + gt];
        dv_acc[nd][j] += red[(16 + nd * 4 + j) * kGroupThreads + gt];
      }
    const size_t head = ((size_t)b * a.s_k * a.h + hh) * kD;
    const int key = k0 + 16 * kw + g;
    store_rows(dk + head, ld, dk_acc, key, a.s_k, a.scale, a.scale, t);
    store_rows(dv + head, ld, dv_acc, key, a.s_k, 1.f, 1.f, t);
  }

  // dq: block r sums m-tiles r, r + n, ... of the n partials in rank order
  cluster_wait();
  const float* dq_parts = reinterpret_cast<const float*>(tiles);
  const int mine = (n_mt - rank + n - 1) / n;  // m-tiles of this block
  __nv_bfloat16* dqb = dq + ((size_t)b * a.s_q * a.h + hh) * kD;
  for (int it = threadIdx.x; it < mine * 16 * (kD / 4); it += kCThreads) {
    const int mt = rank + n * (it / (16 * (kD / 4))), r16 = (it / (kD / 4)) % 16;
    const int row = 16 * mt + r16, c4 = 4 * (it % (kD / 4));
    if (row >= a.s_q) continue;
    const int at = mt * (kChunk / 2) + dq_index(r16, c4);
    float4 part[kMaxClusterTiles];  // all n loads in flight, then the sum in rank order
#pragma unroll
    for (int r = 0; r < kMaxClusterTiles; ++r)
      if (r < n)
        part[r] = *reinterpret_cast<const float4*>(
            (r == rank ? dq_parts : cluster.map_shared_rank(dq_parts, r)) + at);
    float4 s = part[0];
#pragma unroll
    for (int r = 1; r < kMaxClusterTiles; ++r)
      if (r < n) s.x += part[r].x, s.y += part[r].y, s.z += part[r].z, s.w += part[r].w;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dqb + row * ld + c4);
    out[0] = __floats2bfloat162_rn(s.x * a.scale, s.y * a.scale);
    out[1] = __floats2bfloat162_rn(s.z * a.scale, s.w * a.scale);
  }
  // no block leaves while another reads its shared memory
  cluster_arrive_relaxed();
  cluster_wait();
}

// ------------------------------------------------ long routes: Sq or Sk above 512

constexpr int kLongMaxS = 8192;  // queries and keys of a long launch: their rows sit in shared memory
constexpr int kWg = 128;         // threads of a warpgroup
constexpr int kStages = 4;       // a warpgroup's ring of stages
constexpr int kTileBytes = kTile * kD * 2;   // a 64 x 32 bf16 tile: 64-byte rows
constexpr int kStageBytes = 2 * kTileBytes;  // a stage: K and V, or Q and G, tiles
constexpr int kMaxLongGroups = 3;            // key groups (warpgroups) of a forward block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64 x 32 tile in shared memory has rows of 64 bytes in the 64-byte
// swizzle: the 16-byte chunk c of row r sits at 64 r + 16 (c ^ (r / 2 % 4)),
// what a TMA box of one head's 64 rows writes with CU_TENSOR_MAP_SWIZZLE_64B;
// tiles start 1024-byte aligned. Its wgmma descriptor: 8-row groups 512
// bytes apart, layout type 2 (64-byte swizzle)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}
// the tile as B^T of a product (N = its rows, K = its columns, K-major),
// k-step ks taking columns 16 ks .. 16 ks + 15
__device__ __forceinline__ uint64_t desc_rows(uint32_t tile, int ks) {
  return sw64_desc(tile + 32 * ks);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across the async products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

// d (64 x 64) (+)= A (64 x 16: this warp's 16 rows in registers, mma.sync's
// A layout) B, B from a K-major descriptor. d[nt][j] is mma.sync's
// accumulator layout of n-tile nt: row g (+8 for j >= 2), column 8 nt + 2 t + (j & 1)
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(db));
}

// (x0, x1) -> hi = x truncated to bf16 (its top 16 bits, a byte permute),
// lo = bf16(x - hi), packed low half first: one conversion a pair where
// split2 takes two and unpacks hi. |x - hi| < one bf16 ulp of x, so hi + lo
// keeps ~16 bits (an error under 2^-16 of x; split2's, 2^-17)
__device__ __forceinline__ void split2_trunc(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = bits(__floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xffff0000u),
                                  x1 - __uint_as_float(u1 & 0xffff0000u)));
}

// the tile as B (K = its rows, N = its columns: MN-major, wgmma's
// transposed B), k-step kk taking rows 16 kk .. 16 kk + 15
__device__ __forceinline__ uint64_t desc_cols(uint32_t tile, int kk) {
  return sw64_desc(tile + 1024 * kk);
}

// d (64 x 32) += A (64 x 16 in registers) B, B from an MN-major descriptor
__device__ __forceinline__ void wgmma_n32t(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// acc (64 x 32) += X (64 x 64 fp32 in the accumulator layout, as hi + lo
// bf16 terms: split2_trunc) Y, Y a 64 x 32 tile taken as B (K = its rows):
// wgmma m64n32k16 with the terms as register A operands, then waits for
// them. The weights keep ~16 bits.
__device__ __forceinline__ void wgmma_split(float (&acc)[4][4], const float (&x)[8][4],
                                            uint32_t y) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split2_trunc(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split2_trunc(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    split2_trunc(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split2_trunc(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_n32t(acc, hi[kk], desc_cols(y, kk));
    wgmma_n32t(acc, lo[kk], desc_cols(y, kk));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
}

// A fragments of rows row0 .. row0 + 15 of a (B, S, H, 32) head (head
// points at its row 0), read from global memory; rows past n_rows are zeros
__device__ __forceinline__ void load_a_global(uint32_t (&a)[2][4], const __nv_bfloat16* head,
                                              long long row_stride, int row0, int n_rows, int g,
                                              int t) {
  const bool v0 = row0 + g < n_rows, v1 = row0 + g + 8 < n_rows;
  const __nv_bfloat16* p0 = head + (long long)(row0 + g) * row_stride + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * row_stride;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    a[ks][0] = v0 ? lds32(p0 + 16 * ks) : 0u;
    a[ks][1] = v1 ? lds32(p1 + 16 * ks) : 0u;
    a[ks][2] = v0 ? lds32(p0 + 16 * ks + 8) : 0u;
    a[ks][3] = v1 ? lds32(p1 + 16 * ks + 8) : 0u;
  }
}

// one tensor that a ring streams: its tensor map and the head it reads
struct TileSrc {
  const CUtensorMap* map;
  int b, h;
};

// rows [row0, row0 + 64) of x and y into a stage, rows past S zero-filled
// by the maps: lane 0 arms the stage's barrier for its bytes and issues
// one TMA box a tensor, completing on it
__device__ __forceinline__ void fill_stage(uint32_t stage, uint32_t bar, const TileSrc& x,
                                           const TileSrc& y, int row0, int lane) {
  if (lane != 0) return;
  mbar_expect_tx(bar, kStageBytes);
  tma_load_4d(stage, x.map, bar, 0, x.h, row0, x.b);
  tma_load_4d(stage + kTileBytes, y.map, bar, 0, y.h, row0, y.b);
}

// a ring's full barriers, one arrival each (the TMA's expect_tx)
__device__ __forceinline__ void init_ring(uint32_t bars) {
#pragma unroll
  for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait until the j-th tile of a ring has landed
__device__ __forceinline__ void wait_stage(uint32_t bars, int j) {
  mbar_wait(bars + 8 * (j % kStages), (j / kStages) & 1);
}

// the warpgroup's four warps (named barrier `id`): all of them are done
// reading a stage before it is refilled
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWg) : "memory");
}

// Byte offsets of a long forward block's shared memory, from its first
// 1024-byte boundary: each warpgroup's ring, every key's bias (log2 units),
// key groups 1..'s states for the merge, the rings' barriers
struct LongFwdSmem {
  int bias, merge, bars, total;
};

__host__ __device__ inline LongFwdSmem long_fwd_smem(int n_kt, int groups) {
  LongFwdSmem s;
  s.bias = groups * kStages * kStageBytes;
  s.merge = s.bias + n_kt * kTile * 4;
  s.bars = s.merge + (groups - 1) * kMergeVals * kWg * 4;
  s.total = s.bars + groups * kStages * 8 + 1024;  // and the alignment
  return s;
}

// grid (ceil(Sq / 64), B * H) of `groups` warpgroups (the wrapper's
// long_fwd_plan). A block takes 64 query rows of one (b, h); warpgroup k
// takes them over key group k's tiles (group_first_tile), streamed by TMA
// through its own ring of kStages stages, and holds Q in registers: S = Q
// K^T and O += P V run on wgmma, the softmax in log2 units (x = s scale
// log2 e + bias log2 e, then ex2). Groups 1.. hand their max, sums and
// accumulators to group 0 through shared memory at the end, which writes o
// and, where stats is not null, the residual: each row's max and log-sum
// in log2 units.
__global__ void __launch_bounds__(kMaxLongGroups * kWg, 1)
attn_fwd_long_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, Args a,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int groups = blockDim.x / kWg;
  const int n_kt = (a.s_k + kTile - 1) / kTile;
  const LongFwdSmem off = long_fwd_smem(n_kt, groups);
  const uint32_t raw = smem_addr(lsm), base = (raw + 1023) & ~1023u;
  float* bias_s = reinterpret_cast<float*>(lsm + (base - raw) + off.bias);
  float* merge_s = reinterpret_cast<float*>(lsm + (base - raw) + off.merge);

  const int wg = threadIdx.x / kWg, wt = threadIdx.x % kWg;
  const int lane = threadIdx.x & 31, wq = wt >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  const int q0 = blockIdx.x * kTile;
  const int t0 = group_first_tile(wg, n_kt, groups);
  const int n = group_first_tile(wg + 1, n_kt, groups) - t0;  // this group's tiles
  const uint32_t ring = base + wg * kStages * kStageBytes;
  const uint32_t bars = base + off.bars + wg * kStages * 8;
  const TileSrc ks = {&tm_k, b, hh}, vs = {&tm_v, b, hh};

  if (wt == 0) init_ring(bars);
  const float* biasb = a.bias ? a.bias + (size_t)b * a.s_k : nullptr;
  for (int i = threadIdx.x; i < n_kt * kTile; i += blockDim.x)
    bias_s[i] = i < a.s_k ? (biasb ? biasb[i] * kLog2e : 0.f) : -INFINITY;
  __syncthreads();  // the barriers set up, the bias whole
  if (wq == 0)
    for (int j = 0; j < n && j < kStages; ++j)
      fill_stage(ring + j * kStageBytes, bars + 8 * j, ks, vs, (t0 + j) * kTile, lane);

  uint32_t qa[2][4];
  load_a_global(qa, a.q + b * a.sq.b + hh * a.sq.h, a.sq.s, q0 + 16 * wq, a.s_q, g, t);
  const float c = a.scale * kLog2e;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[4][4], sc[8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;

  // Tile by tile: S = Q K^T on wgmma, then the softmax and O += P V. Issuing
  // the next tile's S before this tile's softmax (two score buffers) cost
  // 153 registers and a warpgroup of occupancy, and ran slower (PERF.md
  // §6): the SM's other warpgroups cover the wait
  for (int j = 0; j < n; ++j) {
    const int kt = t0 + j;
    const uint32_t stage = ring + (j % kStages) * kStageBytes;
    wait_stage(bars, j);
    wgmma_fence();
    wgmma_n64(sc, qa[0], desc_rows(stage, 0), 0);
    wgmma_n64(sc, qa[1], desc_rows(stage, 1), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(sc);
    // x = s c + bias log2(e), then p = ex2(x - m): one FFMA and the exp a
    // score. Where no key of the tile has a bias (no mask, no key past Sk)
    // the scores stay s, the max is taken on them and c folds into the
    // exp's FFMA (cc = c), else cc = 1
    const bool biased = a.bias || (kt + 1) * kTile > a.s_k;
    if (biased) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + kt * kTile + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = fmaf(sc[nt][e], c, (e & 1) ? bb.y : bb.x);
      }
    }
    const float cc = biased ? 1.f : c;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every tile holds a real key, so the new max is finite
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * cc);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[nt][e], cc, -m_run[e >> 1]));
        sc[nt][e] = p;
        l_run[e >> 1] += p;
      }
    wgmma_split(acc, sc, stage + kTileBytes);  // acc += P V
    wg_sync(1 + wg);  // every warp's products are done with the stage
    if (wq == 0 && j + kStages < n)
      fill_stage(stage, bars + 8 * (j % kStages), ks, vs, (kt + kStages) * kTile, lane);
  }

  // groups 1..'s states (a max of -inf and zero sums where a group took no tile)
  if (wg > 0) {
    float* mine = merge_s + (wg - 1) * kMergeVals * kWg + wt;
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(nd * 4 + e) * kWg] = acc[nd][e];
    mine[16 * kWg] = m_run[0];
    mine[17 * kWg] = m_run[1];
    mine[18 * kWg] = l_run[0];
    mine[19 * kWg] = l_run[1];
  }
  __syncthreads();
  if (wg > 0) return;
  for (int other_g = 1; other_g < groups; ++other_g) {
    const float* other = merge_s + (other_g - 1) * kMergeVals * kWg + wt;
    float alpha[2], beta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mb = other[(16 + r) * kWg];
      const float m = fmaxf(m_run[r], mb);  // group 0's max is finite: tile 0 holds key 0
      alpha[r] = ex2(m_run[r] - m);
      beta[r] = ex2(mb - m);
      l_run[r] = l_run[r] * alpha[r] + other[(18 + r) * kWg] * beta[r];
      m_run[r] = m;
    }
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nd][e] = acc[nd][e] * alpha[e >> 1] + other[(nd * 4 + e) * kWg] * beta[e >> 1];
  }

  const int row = q0 + 16 * wq + g;
  const float l0 = quad_sum(l_run[0]), l1 = quad_sum(l_run[1]);
  store_rows(o + ((size_t)b * a.s_q * a.h + hh) * kD, (long long)a.h * kD, acc, row, a.s_q,
             1.f / l0, 1.f / l1, t);
  if (t == 0 && stats) {
    const size_t n_all = (size_t)gridDim.y * a.s_q;
    float* m_out = stats + (size_t)bh * a.s_q;
    if (row < a.s_q) m_out[row] = m_run[0], m_out[n_all + row] = log2f(l0);
    if (row + 8 < a.s_q) m_out[row + 8] = m_run[1], m_out[n_all + row + 8] = log2f(l1);
  }
}

// Byte offsets of a long backward block's shared memory, from its first
// 1024-byte boundary: the ring, the per-row arrays (a key tile's block: m,
// L and D of every query; a query tile's block: every key's bias), the
// ring's barriers
struct LongBwdSmem {
  int rows, bars, total;
};

__host__ __device__ inline LongBwdSmem long_bwd_smem(int sq_p, int sk_p) {
  LongBwdSmem s;
  s.rows = kStages * kStageBytes;
  s.bars = s.rows + (3 * sq_p > sk_p ? 3 * sq_p : sk_p) * 4;
  s.total = s.bars + kStages * 8 + 1024;  // and the alignment
  return s;
}

// The block of query tile qt of head bh in the long backward, one
// warpgroup: Q and G in registers as the A operands, every key tile's K and
// V streamed through its ring, S = Q K^T and dP = G V^T on wgmma and P =
// exp2(S c + bias - m - L). With kRowsum (the first launch) it sums D =
// rowsum(dP * P) of its rows, each thread over its keys in tile order, then
// the quad in order, into drow; else (the main launch) it forms dS = P (dP
// - D) with drow's D and sums dq += dS k over the key tiles in order.
template <bool kRowsum>
__device__ __forceinline__ void query_tile_block(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                                 const Args& a, int qt, int bh,
                                                 const __nv_bfloat16* gout, const float* stats,
                                                 float* drow, __nv_bfloat16* dq,
                                                 unsigned char* lsm) {
  const int n_kt = (a.s_k + kTile - 1) / kTile, n_qt = (a.s_q + kTile - 1) / kTile;
  const LongBwdSmem off = long_bwd_smem(n_qt * kTile, n_kt * kTile);
  const uint32_t raw = smem_addr(lsm), base = (raw + 1023) & ~1023u;
  float* bias_s = reinterpret_cast<float*>(lsm + (base - raw) + off.rows);
  const uint32_t bars = base + off.bars;
  const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = bh / a.h, hh = bh % a.h;
  const long long ld = (long long)a.h * kD;  // token stride of g and dq
  const size_t n_all = (size_t)gridDim.x * a.s_q;
  const float c = a.scale * kLog2e;
  const __nv_bfloat16* gb = gout + ((size_t)b * a.s_q * a.h + hh) * kD;
  const float* m_in = stats + (size_t)bh * a.s_q;  // the max, then (n_all on) the log-sum
  const int q0 = qt * kTile;

  if (threadIdx.x == 0) init_ring(bars);
  const float* biasb = a.bias ? a.bias + (size_t)b * a.s_k : nullptr;
  for (int i = threadIdx.x; i < n_kt * kTile; i += kWg)
    bias_s[i] = i < a.s_k ? (biasb ? biasb[i] * kLog2e : 0.f) : -INFINITY;
  __syncthreads();  // the barriers set up, the bias whole
  const TileSrc ks = {tm_k, b, hh}, vs = {tm_v, b, hh};
  if (wq == 0)
    for (int j = 0; j < n_kt && j < kStages; ++j)
      fill_stage(base + j * kStageBytes, bars + 8 * j, ks, vs, j * kTile, lane);

  uint32_t qa[2][4], ga[2][4];
  load_a_global(qa, a.q + b * a.sq.b + hh * a.sq.h, a.sq.s, q0 + 16 * wq, a.s_q, g, t);
  load_a_global(ga, gb, ld, q0 + 16 * wq, a.s_q, g, t);
  const int row = q0 + 16 * wq + g;
  float m[2], l[2], d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = row + 8 * r < a.s_q;
    // an m of +inf makes P = 0 for the rows past Sq
    m[r] = valid ? m_in[row + 8 * r] : INFINITY;
    l[r] = valid ? m_in[n_all + row + 8 * r] : 0.f;
    d[r] = valid && !kRowsum ? drow[(size_t)bh * a.s_q + row + 8 * r] : 0.f;
  }
  float dq_acc[4][4], s[8][4], dp[8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const uint32_t stage = base + (j % kStages) * kStageBytes;
    wait_stage(bars, j);
    wgmma_fence();
    wgmma_n64(s, qa[0], desc_rows(stage, 0), 0);  // S = Q K^T
    wgmma_n64(s, qa[1], desc_rows(stage, 1), 1);
    wgmma_n64(dp, ga[0], desc_rows(stage + kTileBytes, 0), 0);  // dP = G V^T
    wgmma_n64(dp, ga[1], desc_rows(stage + kTileBytes, 1), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 bb = *reinterpret_cast<const float2*>(bias_s + j * kTile + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = ex2((fmaf(s[nt][e], c, (e & 1) ? bb.y : bb.x) - m[r]) - l[r]);
        if (kRowsum)
          d[r] = fmaf(p, dp[nt][e], d[r]);
        else
          dp[nt][e] = p * (dp[nt][e] - d[r]);
      }
    }
    if (!kRowsum) wgmma_split(dq_acc, dp, stage);  // dq += dS k
    wg_sync(1);  // every warp's products are done with the stage
    if (wq == 0 && j + kStages < n_kt)
      fill_stage(stage, bars + 8 * (j % kStages), ks, vs, (j + kStages) * kTile, lane);
  }
  if (kRowsum) {
    const float d0 = quad_sum(d[0]), d1 = quad_sum(d[1]);
    if (t == 0) {
      if (row < a.s_q) drow[(size_t)bh * a.s_q + row] = d0;
      if (row + 8 < a.s_q) drow[(size_t)bh * a.s_q + row + 8] = d1;
    }
  } else {
    store_rows(dq + ((size_t)b * a.s_q * a.h + hh) * kD, ld, dq_acc, row, a.s_q, a.scale,
               a.scale, t);
  }
}

// grid (B * H, ceil(Sq / 64)) of one warpgroup: D = rowsum(dP * P) of every
// query row into drow (query_tile_block<true>), which the long backward
// reads: the TPU kernel's row term, from the same recomputed P and dP as
// the main launch's, so dS sums to zero over the keys up to its rounding.
__global__ void __launch_bounds__(kWg, 4)
attn_bwd_rowsum_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, Args a,
                       const __nv_bfloat16* __restrict__ gout, const float* __restrict__ stats,
                       float* __restrict__ drow) {
  extern __shared__ __align__(16) unsigned char lsm[];
  query_tile_block<true>(&tm_k, &tm_v, a, blockIdx.y, blockIdx.x, gout, stats, drow, nullptr,
                         lsm);
}

// grid (B * H, ceil(Sk / 64) + ceil(Sq / 64)) of one warpgroup, so every
// head's key-tile blocks, the longer ones, are dispatched before any
// query-tile block. Block y < ceil(Sk / 64) owns key tile y: K and V in
// registers as the A operands, it streams every query tile's Q and G
// through its ring and computes P^T = exp2(K Q^T c + bias - m - L) and dP^T
// = V G^T, dS^T = P^T (dP^T - D), then dv += P^T g and dk += dS^T q, summed
// over the query tiles in order and written once. The other blocks own a
// query tile (query_tile_block<false>): dq += dS k over the key tiles in
// order. No block waits on another, no atomics: two calls give the same
// bits. D comes from attn_bwd_rowsum_kernel, launched first.
__global__ void __launch_bounds__(kWg, 3)
attn_bwd_long_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g, Args a,
                     const __nv_bfloat16* __restrict__ gout, const float* __restrict__ stats,
                     float* __restrict__ drow, __nv_bfloat16* __restrict__ dq,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int n_kt = (a.s_k + kTile - 1) / kTile, n_qt = (a.s_q + kTile - 1) / kTile;
  if (blockIdx.y >= n_kt) {
    query_tile_block<false>(&tm_k, &tm_v, a, blockIdx.y - n_kt, blockIdx.x, gout, stats, drow,
                            dq, lsm);
    return;
  }
  // ----------------------------------------------- key tile: dk and dv
  const LongBwdSmem off = long_bwd_smem(n_qt * kTile, n_kt * kTile);
  const uint32_t raw = smem_addr(lsm), base = (raw + 1023) & ~1023u;
  float* rows_s = reinterpret_cast<float*>(lsm + (base - raw) + off.rows);
  const uint32_t bars = base + off.bars;
  const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const long long ld = (long long)a.h * kD;  // token stride of g, dk and dv
  const size_t n_all = (size_t)gridDim.x * a.s_q;
  const float c = a.scale * kLog2e;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hh * a.sv.h;
  const float* m_in = stats + (size_t)bh * a.s_q;  // the max, then (n_all on) the log-sum
  const float* d_in = drow + (size_t)bh * a.s_q;
  if (threadIdx.x == 0) init_ring(bars);
  const int k0 = blockIdx.y * kTile, sq_p = n_qt * kTile;
  float* m_s = rows_s;
  float* l_s = rows_s + sq_p;
  float* d_s = rows_s + 2 * sq_p;
  for (int i = threadIdx.x; i < sq_p; i += kWg) {
    const bool valid = i < a.s_q;
    // an m of +inf makes P = 0 for the queries past Sq
    m_s[i] = valid ? m_in[i] : INFINITY;
    l_s[i] = valid ? m_in[n_all + i] : 0.f;
    d_s[i] = valid ? d_in[i] : 0.f;
  }
  __syncthreads();  // the barriers set up, the rows whole
  const TileSrc qs = {&tm_q, b, hh}, gs = {&tm_g, b, hh};
  if (wq == 0)
    for (int j = 0; j < n_qt && j < kStages; ++j)
      fill_stage(base + j * kStageBytes, bars + 8 * j, qs, gs, j * kTile, lane);

  uint32_t ka[2][4], va[2][4];
  load_a_global(ka, kb, a.sk.s, k0 + 16 * wq, a.s_k, g, t);
  load_a_global(va, vb, a.sv.s, k0 + 16 * wq, a.s_k, g, t);
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * wq + g + 8 * r;
    bias_r[r] = key < a.s_k ? (a.bias ? a.bias[(size_t)b * a.s_k + key] * kLog2e : 0.f)
                            : -INFINITY;
  }
  float dk_acc[4][4], dv_acc[4][4], st[8][4], dpt[8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;

  for (int j = 0; j < n_qt; ++j) {
    const uint32_t stage = base + (j % kStages) * kStageBytes;
    wait_stage(bars, j);
    wgmma_fence();
    wgmma_n64(st, ka[0], desc_rows(stage, 0), 0);  // S^T = K Q^T
    wgmma_n64(st, ka[1], desc_rows(stage, 1), 1);
    wgmma_n64(dpt, va[0], desc_rows(stage + kTileBytes, 0), 0);  // dP^T = V G^T
    wgmma_n64(dpt, va[1], desc_rows(stage + kTileBytes, 1), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(st);
    fence_acc(dpt);
    // row: a key (bias_r); column: query 64 j + 8 nt + 2 t + (e & 1)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int qc = j * kTile + nt * 8 + 2 * t;
      const float2 mm = *reinterpret_cast<const float2*>(m_s + qc);
      const float2 ll = *reinterpret_cast<const float2*>(l_s + qc);
      const float2 dd = *reinterpret_cast<const float2*>(d_s + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(st[nt][e], c, bias_r[e >> 1]);
        const float p = ex2((x - ((e & 1) ? mm.y : mm.x)) - ((e & 1) ? ll.y : ll.x));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dd.y : dd.x));
      }
    }
    wgmma_split(dv_acc, st, stage + kTileBytes);  // dv += P^T g
    wgmma_split(dk_acc, dpt, stage);              // dk += dS^T q
    wg_sync(1);  // every warp's products are done with the stage
    if (wq == 0 && j + kStages < n_qt)
      fill_stage(stage, bars + 8 * (j % kStages), qs, gs, (j + kStages) * kTile, lane);
  }
  const size_t head = ((size_t)b * a.s_k * a.h + hh) * kD;
  const int key = k0 + 16 * wq + g;
  store_rows(dk + head, ld, dk_acc, key, a.s_k, a.scale, a.scale, t);
  store_rows(dv + head, ld, dv_acc, key, a.s_k, 1.f, 1.f, t);
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               const long long* strides, int h, int s_q, int s_k, float scale) {
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.bias = (const float*)bias;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.h = h;
  a.s_q = s_q;
  a.s_k = s_k;
  a.scale = scale;
  return a;
}

// the resident forward's shared memory limit, set once: it holds for the
// process
cudaError_t configure_fwd_kernel() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmemMax);
  configured = err == cudaSuccess;
  return err;
}

// the cluster kernel's shared memory limit and carveout, set once: they
// hold for the process
cudaError_t configure_cluster_kernel() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bwd_smem(kClusterMaxS).total);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_cluster_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  configured = err == cudaSuccess;
  return err;
}

// the cluster route's launch: grid (n, B * H), clusters of n = ceil(Sk / 64)
cudaLaunchConfig_t cluster_config(int b, int h, int s_q, int s_k, void* stream,
                                  cudaLaunchAttribute (&attr)[1]) {
  const int n = (s_k + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, b * h);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = bwd_smem((s_q + 15) & ~15).total;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the long kernels' shared memory limits, set once: they hold for the process
cudaError_t configure_long_kernels() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  const int fwd = long_fwd_smem(kLongMaxS / kTile, kMaxLongGroups).total;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_long_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fwd);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               long_bwd_smem(kLongMaxS, kLongMaxS).total);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_rowsum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               long_bwd_smem(kLongMaxS, kLongMaxS).total);
  configured = err == cudaSuccess;
  return err;
}

// the tensor map of one (B, S, H, 32) bf16 tensor with element strides st:
// boxes of 64 rows of one head in the 64-byte swizzle, rows past S zero-filled
bool head_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int b, int s, int h,
              const Strides& st) {
  const cuuint64_t dims[4] = {kD, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kD, 1, kTile, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps of n tensors; false where the encoder is missing or any map
// fails to encode
bool head_maps(CUtensorMap* maps, const void* const* ptrs, const Strides* st, const int* rows,
               int n, int b, int h) {
  const EncodeTiled encode = encode_fn();
  bool ok = encode != nullptr;
  for (int i = 0; i < n && ok; ++i) ok = head_map(encode, &maps[i], ptrs[i], b, rows[i], h, st[i]);
  return ok;
}

}  // namespace

// How many blocks of the long forward (`groups` warpgroups, Sk keys) one
// SM holds at once, into *blocks: kernels/attention.py::long_fwd_plan reads it.
extern "C" int objcavit_attention_long_fwd_blocks(int groups, int s_k, int* blocks) {
  *blocks = 0;
  if (groups < 1 || groups > kMaxLongGroups || s_k < 1 || s_k > kLongMaxS)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = configure_long_kernels();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_fwd_long_kernel, kWg * groups,
      long_fwd_smem((s_k + kTile - 1) / kTile, groups).total);
}

// q (B, Sq, H, 32), k and v (B, Sk, H, 32) bf16, unit-stride in the head
// dimension, 16-byte aligned, every stride a multiple of 8 elements; strides
// = the (batch, token, head) element strides of q, then k, then v. bias
// (B, Sk) fp32 contiguous or null. o (B, Sq, H, 32) bf16 contiguous; stats
// (2, B * H, Sq) fp32, or null where no backward reads it: each row's max,
// then its log-sum (in log2 units on the long routes). Up to 512 keys and queries the head's keys are resident (one
// block holds its whole K, V and bias) and plan_rows, plan_groups are that
// kernel's plan (kernels/attention.py::fwd_plan: 1 <= rows <= 8, 1 <=
// groups <= min(4, key tiles), rows * groups <= 16); beyond, plan_rows is
// 0 and plan_groups the long kernel's warpgroups (long_fwd_plan: 1 <= groups
// <= min(3, key tiles)), and Sq, Sk are at most 8192. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// or a length the kernels do not take.
extern "C" int objcavit_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, void* stats,
                                      const long long* strides, int b, int h, int s_q, int s_k,
                                      float scale, int plan_rows, int plan_groups, void* stream) {
  if (b == 0 || h == 0 || s_q == 0) return (int)cudaSuccess;
  if (s_k == 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, bias, strides, h, s_q, s_k, scale);
  const int n_kt = (s_k + kTile - 1) / kTile;
  if (s_q <= kClusterMaxS && s_k <= kClusterMaxS) {
    const FwdPlan plan = {plan_rows, plan_groups};
    if (plan.rows < 1 || plan.rows > 8 || plan.groups < 1 || plan.groups > kMaxKeyGroups ||
        plan.groups > n_kt || plan.rows * plan.groups > kMaxFWarps)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = configure_fwd_kernel();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s_q + 16 * plan.rows - 1) / (16 * plan.rows), b * h);
    attn_fwd_resident_kernel<<<grid, 32 * plan.rows * plan.groups,
                               fwd_smem(n_kt, plan.rows, plan.groups).total,
                               (cudaStream_t)stream>>>(a, plan, (__nv_bfloat16*)o, (float*)stats);
  } else {
    if (plan_rows != 0 || plan_groups < 1 || plan_groups > kMaxLongGroups || plan_groups > n_kt ||
        s_q > kLongMaxS || s_k > kLongMaxS)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = configure_long_kernels();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap maps[2] = {};
    const void* ptrs[2] = {k, v};
    const Strides st[2] = {a.sk, a.sv};
    const int rows[2] = {s_k, s_k};
    if (!head_maps(maps, ptrs, st, rows, 2, b, h)) return (int)cudaErrorInvalidValue;
    const dim3 grid((s_q + kTile - 1) / kTile, b * h);
    const int smem = long_fwd_smem(n_kt, plan_groups).total;
    attn_fwd_long_kernel<<<grid, kWg * plan_groups, smem, (cudaStream_t)stream>>>(
        maps[0], maps[1], a, (__nv_bfloat16*)o, (float*)stats);
  }
  return (int)cudaGetLastError();
}

// How many of the cluster route's clusters (Sq, Sk at most 512) the card
// holds at once, into *clusters; a launch of more runs in waves.
extern "C" int objcavit_attention_bwd_clusters(int b, int h, int s_q, int s_k, int* clusters) {
  *clusters = 0;
  cudaError_t err = configure_cluster_kernel();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(b, h, s_q, s_k, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, attn_bwd_cluster_kernel, &cfg);
}

// As the forward, plus g (B, Sq, H, 32) bf16 contiguous (the gradient of o),
// stats from the forward, dq (B, Sq, H, 32), dk and dv (B, Sk, H, 32) bf16
// contiguous, and drow (B * H, Sq) fp32 scratch for the long route's row
// term. With Sq and Sk at most 512 it launches the cluster kernel and sets
// *route to 1; otherwise the row-sum kernel, then the long backward, on
// the stream, and *route to 2.
extern "C" int objcavit_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* bias, const void* g, const void* stats,
                                      void* dq, void* dk, void* dv, void* drow,
                                      const long long* strides, int b, int h, int s_q, int s_k,
                                      float scale, int* route, void* stream) {
  *route = 0;
  if (b == 0 || h == 0 || s_q == 0 || s_k == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, bias, strides, h, s_q, s_k, scale);
  if (s_q <= kClusterMaxS && s_k <= kClusterMaxS) {
    const cudaError_t err = configure_cluster_kernel();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(b, h, s_q, s_k, stream, attr);
    *route = 1;
    const cudaError_t launch = cudaLaunchKernelEx(
        &cfg, attn_bwd_cluster_kernel, a, (const __nv_bfloat16*)g, (const float*)stats,
        (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv);
    return (int)(launch != cudaSuccess ? launch : cudaGetLastError());
  }
  *route = 2;
  if (s_q > kLongMaxS || s_k > kLongMaxS) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure_long_kernels();
  if (err != cudaSuccess) return (int)err;
  const Strides sg = {(long long)s_q * h * kD, (long long)h * kD, kD};
  const Strides st[4] = {a.sq, a.sk, a.sv, sg};
  const void* ptrs[4] = {q, k, v, g};
  const int rows[4] = {s_q, s_k, s_k, s_q};
  CUtensorMap maps[4] = {};
  if (!head_maps(maps, ptrs, st, rows, 4, b, h)) return (int)cudaErrorInvalidValue;
  const int n_kt = (s_k + kTile - 1) / kTile, n_qt = (s_q + kTile - 1) / kTile;
  const int smem = long_bwd_smem(n_qt * kTile, n_kt * kTile).total;
  attn_bwd_rowsum_kernel<<<dim3(b * h, n_qt), kWg, smem, (cudaStream_t)stream>>>(
      maps[1], maps[2], a, (const __nv_bfloat16*)g, (const float*)stats, (float*)drow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_long_kernel<<<dim3(b * h, n_kt + n_qt), kWg, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], a, (const __nv_bfloat16*)g, (const float*)stats,
      (float*)drow, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv);
  return (int)cudaGetLastError();
}
