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
// Design. The TPU kernel keeps a whole (Sq, Sk) score tile of one (b, h) in
// VMEM; here the scores never leave registers. Flash-style, in tiles of 64
// keys: both products run on the tensor cores, mma.sync m16n8k16 bf16 with
// fp32 accumulators; the softmax is online in fp32 (running row max and
// sum). The weights enter the w v product split in two bf16 terms, hi =
// bf16(w) and lo = bf16(w - hi), so they keep ~16 bits, not 8: the TPU
// kernel multiplies fp32 weights. The same split carries ds and w into the
// backward's products.
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
// grad, or no input needing it), it is not written. Beyond 512 keys a
// block of 4 warps takes 64 rows and streams K and V through two cp.async
// stages.
//
// Hazards. Keys past Sk in the last tile get -inf, so they weigh exactly 0;
// a masked key gets -1e30, so a row whose keys are all masked is uniform
// over its Sk real keys, as in the TPU kernel. The forward's residual for
// the backward is each row's max m and log-sum L = log sum exp(s - m), kept
// apart: their sum, the log-sum-exp, rounds to -1e30 on a fully masked row
// and would lose the 1/Sk.
//
// Backward, no atomics, so the result does not depend on timing. D is the
// row term rowsum(dP * P) (dP = g v^T; the TPU kernel's rowsum(dw * w), not
// rowsum(g * o) of the rounded output). Two routes, chosen by shape in the
// entry point:
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
// Two-kernel route (Sq or Sk above 512: more than 8 key tiles exceed the
// portable cluster size): one kernel per (query tile, b*h) first sums D over all key tiles,
// writes it, then takes a second pass over the key tiles to accumulate dq.
// A second kernel per (key tile, b*h), launched after it, loops over the
// query tiles to accumulate dk and dv, reading m, L and D. Both recompute P
// from q, k and the residual.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 32;       // head dimension
constexpr int kTile = 64;    // rows of a block's tile: queries, or keys
constexpr int kWarps = 4;    // 16 rows a warp
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;  // shared row stride (bf16): 80 bytes, conflict-free fragments

struct Strides {
  long long b, s, h;  // element strides of a (B, S, H, D) view; D is unit-stride
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// a 64-row tile by a block of kThreads threads
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int n_rows) {
  load_rows<kThreads>(dst, base, row_stride, row0, kTile, n_rows);
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

// grid (ceil(Sq / 64), B * H)
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(Args a, __nv_bfloat16* __restrict__ o, float* __restrict__ stats) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTile * kLd];
  __shared__ float bias_s[2][kTile];

  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = a.q + b * a.sq.b + hh * a.sq.h;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hh * a.sv.h;
  const float* biasb = a.bias ? a.bias + (size_t)b * a.s_k : nullptr;

  auto load_kv = [&](int stage, int kt) {
    load_tile(k_s[stage], kb, a.sk.s, kt * kTile, a.s_k);
    load_tile(v_s[stage], vb, a.sv.s, kt * kTile, a.s_k);
    if (threadIdx.x < kTile) {
      const int key = kt * kTile + threadIdx.x;
      bias_s[stage][threadIdx.x] = key < a.s_k ? (biasb ? biasb[key] : 0.f) : -INFINITY;
    }
  };

  load_tile(q_s, qb, a.sq.s, q0, a.s_q);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qa[2][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[4][4];
#pragma unroll
  for (int nd = 0; nd < 4; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int n_kt = (a.s_k + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) load_kv(st ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) load_a(qa, q_s, warp * 16, g, t);

    fwd_tile(qa, k_s[st], v_s[st], bias_s[st], a.scale, m_run, l_run, acc, lane, g, t);
    __syncthreads();  // stage st is refilled in the next iteration
  }

  const int row = q0 + warp * 16 + g;
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

// P of a 16 x 64 score fragment in place, from the residual of its rows:
// x = s * scale + bias, P = exp((x - m) - L)
__device__ __forceinline__ void probs_rows(float (&s)[8][4], const float* bias_tile,
                                           const float (&m)[2], const float (&lsum)[2],
                                           float scale, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = s[nt][j] * scale + bias_tile[nt * 8 + 2 * t + (j & 1)];
      s[nt][j] = __expf((x - m[j >> 1]) - lsum[j >> 1]);
    }
}

// grid (ceil(Sq / 64), B * H): D = rowsum(dP * P) into drow, then dq
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(Args a, const __nv_bfloat16* __restrict__ gout,
                   const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
                   float* __restrict__ drow) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 g_s[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTile * kLd];
  __shared__ float bias_s[2][kTile];

  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const long long ld = (long long)a.h * kD;  // token stride of g and dq
  const __nv_bfloat16* qb = a.q + b * a.sq.b + hh * a.sq.h;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hh * a.sv.h;
  const __nv_bfloat16* gb = gout + ((size_t)b * a.s_q * a.h + hh) * kD;
  const float* biasb = a.bias ? a.bias + (size_t)b * a.s_k : nullptr;

  auto load_kv = [&](int stage, int kt) {
    load_tile(k_s[stage], kb, a.sk.s, kt * kTile, a.s_k);
    load_tile(v_s[stage], vb, a.sv.s, kt * kTile, a.s_k);
    if (threadIdx.x < kTile) {
      const int key = kt * kTile + threadIdx.x;
      bias_s[stage][threadIdx.x] = key < a.s_k ? (biasb ? biasb[key] : 0.f) : -INFINITY;
    }
  };

  const int row = q0 + warp * 16 + g;
  const size_t n_rows_all = (size_t)gridDim.y * a.s_q;
  const float* m_in = stats + (size_t)bh * a.s_q;
  float m[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    m[r] = rr < a.s_q ? m_in[rr] : 0.f;
    lsum[r] = rr < a.s_q ? m_in[n_rows_all + rr] : 0.f;
  }

  load_tile(q_s, qb, a.sq.s, q0, a.s_q);
  load_tile(g_s, gb, ld, q0, a.s_q);
  uint32_t qa[2][4], ga[2][4];
  const int n_kt = (a.s_k + kTile - 1) / kTile;
  float dsum[2] = {0.f, 0.f};
  float d[2];
  float acc[4][4];
#pragma unroll
  for (int nd = 0; nd < 4; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  // pass 0 sums the row term, pass 1 accumulates dq
  for (int pass = 0; pass < 2; ++pass) {
    load_kv(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < n_kt) load_kv(st ^ 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (pass == 0 && kt == 0) {
        load_a(qa, q_s, warp * 16, g, t);
        load_a(ga, g_s, warp * 16, g, t);
      }
      float p[8][4], dp[8][4];
      mma_by_tile_t(p, qa, k_s[st], g, t);
      probs_rows(p, bias_s[st], m, lsum, a.scale, t);
      mma_by_tile_t(dp, ga, v_s[st], g, t);
      if (pass == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) dsum[j >> 1] += p[nt][j] * dp[nt][j];
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[nt][j] *= dp[nt][j] - d[j >> 1];
        mma_split_by_tile(acc, p, k_s[st], lane);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    if (pass == 0) {
      d[0] = quad_sum(dsum[0]);
      d[1] = quad_sum(dsum[1]);
      if (t == 0) {
        if (row < a.s_q) drow[(size_t)bh * a.s_q + row] = d[0];
        if (row + 8 < a.s_q) drow[(size_t)bh * a.s_q + row + 8] = d[1];
      }
    }
  }
  store_rows(dq + ((size_t)b * a.s_q * a.h + hh) * kD, ld, acc, row, a.s_q, a.scale, a.scale, t);
}

// grid (ceil(Sk / 64), B * H): dk and dv of a tile of 64 keys, over every query tile
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(Args a, const __nv_bfloat16* __restrict__ gout,
                     const float* __restrict__ stats, const float* __restrict__ drow,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 q_s[2][kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 g_s[2][kTile * kLd];
  __shared__ float m_s[2][kTile], l_s[2][kTile], d_s[2][kTile];

  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const long long ld = (long long)a.h * kD;  // token stride of g, dk and dv
  const __nv_bfloat16* qb = a.q + b * a.sq.b + hh * a.sq.h;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hh * a.sv.h;
  const __nv_bfloat16* gb = gout + ((size_t)b * a.s_q * a.h + hh) * kD;
  const size_t n_rows_all = (size_t)gridDim.y * a.s_q;
  const float* m_in = stats + (size_t)bh * a.s_q;
  const float* d_in = drow + (size_t)bh * a.s_q;

  auto load_q = [&](int stage, int qt) {
    load_tile(q_s[stage], qb, a.sq.s, qt * kTile, a.s_q);
    load_tile(g_s[stage], gb, ld, qt * kTile, a.s_q);
    if (threadIdx.x < kTile) {
      const int qi = qt * kTile + threadIdx.x;
      const bool valid = qi < a.s_q;
      // an m of +inf makes P = 0 for the rows past Sq
      m_s[stage][threadIdx.x] = valid ? m_in[qi] : INFINITY;
      l_s[stage][threadIdx.x] = valid ? m_in[n_rows_all + qi] : 0.f;
      d_s[stage][threadIdx.x] = valid ? d_in[qi] : 0.f;
    }
  };

  // this thread's two keys (rows of P^T) and their bias
  const int key = k0 + warp * 16 + g;
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = key + 8 * r;
    bias_r[r] = (a.bias && kr < a.s_k) ? a.bias[(size_t)b * a.s_k + kr] : 0.f;
  }

  load_tile(k_s, kb, a.sk.s, k0, a.s_k);
  load_tile(v_s, vb, a.sv.s, k0, a.s_k);
  load_q(0, 0);
  cp_async_commit();

  uint32_t ka[2][4], va[2][4];
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int nd = 0; nd < 4; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nd][j] = dv_acc[nd][j] = 0.f;

  const int n_qt = (a.s_q + kTile - 1) / kTile;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < n_qt) load_q(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (qt == 0) {
      load_a(ka, k_s, warp * 16, g, t);
      load_a(va, v_s, warp * 16, g, t);
    }
    // P^T (16 keys x 64 queries) and dP^T = v g^T
    float p[8][4], dp[8][4];
    mma_by_tile_t(p, ka, q_s[st], g, t);
    mma_by_tile_t(dp, va, g_s[st], g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = nt * 8 + 2 * t + (j & 1);
        const float x = p[nt][j] * a.scale + bias_r[j >> 1];
        p[nt][j] = __expf((x - m_s[st][qc]) - l_s[st][qc]);
      }
    mma_split_by_tile(dv_acc, p, g_s[st], lane);  // dv += P^T g
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[nt][j] *= dp[nt][j] - d_s[st][nt * 8 + 2 * t + (j & 1)];
    mma_split_by_tile(dk_acc, p, q_s[st], lane);  // dk += dS^T q
    __syncthreads();
  }
  cp_async_wait<0>();
  const size_t head = ((size_t)b * a.s_k * a.h + hh) * kD;
  store_rows(dk + head, ld, dk_acc, key, a.s_k, a.scale, a.scale, t);
  store_rows(dv + head, ld, dv_acc, key, a.s_k, 1.f, 1.f, t);
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

}  // namespace

// q (B, Sq, H, 32), k and v (B, Sk, H, 32) bf16, unit-stride in the head
// dimension, 16-byte aligned, every stride a multiple of 8 elements; strides
// = the (batch, token, head) element strides of q, then k, then v. bias
// (B, Sk) fp32 contiguous or null. o (B, Sq, H, 32) bf16 contiguous; stats
// (2, B * H, Sq) fp32: each row's max, then its log-sum; or null where no
// backward reads them. Up to 512 keys the head's keys are resident (one
// block holds its whole K, V and bias); beyond, they stream through two
// stages. plan_rows and plan_groups are the resident kernel's plan
// (kernels/attention.py::fwd_plan: 1 <= rows <= 8, 1 <= groups <= min(4,
// key tiles), rows * groups <= 16), both 0 beyond 512 keys. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// the kernel does not take.
extern "C" int objcavit_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, void* stats,
                                      const long long* strides, int b, int h, int s_q, int s_k,
                                      float scale, int plan_rows, int plan_groups, void* stream) {
  if (b == 0 || h == 0 || s_q == 0) return (int)cudaSuccess;
  if (s_k == 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, bias, strides, h, s_q, s_k, scale);
  const int n_kt = (s_k + kTile - 1) / kTile;
  if (n_kt <= kResMaxTiles) {
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
    if (plan_rows != 0 || plan_groups != 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((s_q + kTile - 1) / kTile, b * h);
    attn_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, (__nv_bfloat16*)o,
                                                                 (float*)stats);
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
// contiguous, and drow (B * H, Sq) fp32 scratch for the row term of the
// two-kernel route. With Sq and Sk at most 512 it launches the cluster
// kernel and sets *route to 1; otherwise the dq kernel, then the dk/dv
// kernel, on the stream, and *route to 2.
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
  attn_bwd_dq_kernel<<<dim3((s_q + kTile - 1) / kTile, b * h), kThreads, 0,
                       (cudaStream_t)stream>>>(a, (const __nv_bfloat16*)g, (const float*)stats,
                                               (__nv_bfloat16*)dq, (float*)drow);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<<<dim3((s_k + kTile - 1) / kTile, b * h), kThreads, 0,
                         (cudaStream_t)stream>>>(a, (const __nv_bfloat16*)g, (const float*)stats,
                                                 (const float*)drow, (__nv_bfloat16*)dk,
                                                 (__nv_bfloat16*)dv);
  return (int)cudaGetLastError();
}
