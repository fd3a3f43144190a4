// YOLOv7 detect head: 1x1 conv + per-anchor class max/argmax, in one pass.
//
// Replaces the TPU kernel objcavit_tpu/ops/detect_head_pallas.py::
// fused_detect_head (_kernel), the class-max route of YOLOv7-seg serving.
// For each level, with M = B*S positions, Cin channels, nc classes, nm mask
// coefficients and 3 anchors, the dense head is M x Cin @ Cin x 3*(5+nc+nm);
// this kernel writes only what decoding needs:
//
//   y5   (M, 3, 5)   box + objectness, bf16   } fp32 accumulator + fp32 bias,
//   coef (M, 3, nm)  mask coefficients, bf16  } rounded to bf16 once
//   cls_max (M, 3) fp32: max over the nc class logits of each anchor, each
//                  logit first rounded to bf16 (the dense head's precision)
//   cls_arg (M, 3) int32: the first class index that reaches that max
//
// so the (M, 3720) logits of a 1203-class head never reach device memory.
//
// What bounds it on the H100: tensor-core operations. At NYU 480x640 and
// batch 8 the three levels are 128 GFLOP (0.1294 ms at 989 TFLOP/s) against
// ~34 MB of features read and a few MB written, far above the card's ~295
// bf16 flops per byte of HBM.
//
// Design, for Hopper. The work of a level is a list of units, one per
// (row tile of BM positions, 128-column tile): per row tile, anchor 0's
// ncp / 128 class tiles, then anchor 1's and anchor 2's (the class columns,
// repacked once to (3, ncp, Cin) K-major rows, rows past nc zero), then the
// box tile (the 15 box/objectness and 3 nm coefficient columns packed into
// 128 rows of w5c, the TPU kernel's packing). A persistent grid of one block
// an SM takes a contiguous, equal share of the list. A block is three
// warpgroups: a producer and two consumers that take the block's units in
// turns (ping-pong).
//
// * Products on wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate), both
//   operands K-major in 128-byte-swizzled shared memory; a consumer holds
//   one unit's BM x 128 accumulators (BM / 64 m-tiles of 64 registers).
// * Loads by TMA (cp.async.bulk.tensor; tensor maps encoded on the host each
//   call and passed as __grid_constant__ parameters) completed on mbarriers.
//   The producer's first thread streams the weight tiles, 128 columns x 64
//   channels (16 KB), through a ring of as many stages as shared memory
//   holds (4 to 8), with full and empty barriers.
// * Features read once per row tile: the block's feature tile (BM x Cin)
//   stays resident for all of that row tile's units, 3 ncp / 128 + 1 = 31
//   at 1203 classes, and is reloaded when both consumers have handed it
//   back. A consumer hands a tile back only after its own products on it
//   are done and after it has waited for that tile's load
//   (tests/test_torch_schedules.py walks a twin of this protocol). BM is
//   128 where the tile, the ring and the biases fit in 227 KB (Cin <= 512:
//   64 or 128 KB of features), else 64 (Cin 1024: 128 KB).
//   Streaming the features with the weights instead would read them 31
//   times from L2, as much as the weights' own traffic at BM = 128.
// * The epilogue overlaps the products: a consumer queues all of its unit's
//   products, hands the tensor cores to the other consumer (a turn
//   barrier), waits for its own products and folds them while the other's
//   run. The fold adds the biases (staged once per block in shared memory),
//   rounds each logit to bf16, and keeps per row the max and its first
//   column (strict > in column order, over two chains of alternate column
//   groups merged with ties to the smaller column); columns at or past nc
//   never count. Two warpgroups, not one folding between its own next
//   products: a warpgroup's fold stalls the products it would issue next,
//   and the tensor cores go idle.
// * The card is filled at every level by splitting the unit list evenly
//   over the SMs, so an anchor's class tiles may land in two blocks (and
//   are split between the two consumers of a block). Each consumer merges
//   its run's (max, column) per (row, anchor) into a 64-bit key with
//   atomicMax: the high word is the order-preserving bit pattern of the fp32
//   max (-0.0 taken as +0.0), the low word 0xFFFFFFFF - column, so equal
//   maxima go to the smaller column whatever the order. The entry point
//   zeroes the keys first (0 is below every key) and decodes them into
//   cls_max and cls_arg after; kernels/detect_head.py keeps a Python twin of
//   the encoding.
//
// What held the mma.sync version back (1.015 ms at NYU, 13% of peak), and
// what this design does about each: the products run on wgmma; the
// epilogue runs beside the other consumer's products and reads its biases
// from shared memory; the features are read once per row tile of a block,
// not once per column tile; the small levels no longer leave SMs idle or
// run a long tail.

#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda: see encode_fn
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNa = 3;         // anchors per position
constexpr int kBox = 5 * kNa;  // packed box/objectness columns of the box tile
constexpr int kBN = 128;       // columns per tile: wgmma's N
constexpr int kBK = 64;        // channels per 128-byte swizzled chunk
constexpr int kMinStages = 4;  // weight ring depth: as many stages as fit, 4 to 8
constexpr int kMaxStages = 8;
constexpr int kChunkB = kBN * kBK * 2;  // bytes of one weight chunk
constexpr int kOther = 128;    // rows of the packed box/coefficient tile
constexpr size_t kSmemMax = 232448;

size_t smem_bytes(int mt, int cin, int ncp, int stages) {
  return 1024 + (size_t)mt * 64 * cin * 2 + (size_t)stages * kChunkB +
         (size_t)(kNa * ncp + kOther) * 4 + (2 * kMaxStages + 4) * 8;
}

struct Job {
  int m, cin, nc, ncp, nm;
  int kc;       // channel chunks: Cin / 64
  int ntile;    // class tiles of an anchor: ncp / 128
  int per_row;  // units of a row tile: 3 ntile + 1
  int units;
  int stages;   // weight ring depth
};

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

// one 64-channel x `rows` box of a 2-D bf16 tensor map into swizzled smem
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row groups 1024 bytes apart; the tile starts 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the async products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major smem) @ B (16 x 128, K-major smem)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// (v, i) beats (best, arg): larger value, or the same value at a smaller index
__device__ __forceinline__ bool beats(float v, int i, float best, int arg) {
  return v > best || (v == best && i < arg);
}

// the 64-bit merge key: unsigned order = (value, then smaller index)
__device__ __forceinline__ unsigned long long class_key(float v, int idx) {
  uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);  // -0.0 ties with +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)idx);
}

// what the fold needs of a unit, decoded once
struct Unit {
  int r;          // its row tile
  int anchor;     // 0..2 for a class tile, -1 for the box tile
  int col0;       // first class column of a class tile
  bool masked;    // a class tile that holds columns at or past nc
  bool ends_run;  // this warpgroup's last tile of the (row tile, anchor) run
};

// unit u of a warpgroup that takes every second unit of the block's share
__device__ __forceinline__ Unit decode_unit(int u, int u_end, const Job& job) {
  Unit x;
  x.r = u / job.per_row;
  const int c = u - x.r * job.per_row;
  x.anchor = -1;
  x.col0 = 0;
  x.masked = false;
  x.ends_run = false;
  if (c < kNa * job.ntile) {
    x.anchor = c / job.ntile;
    x.col0 = (c - x.anchor * job.ntile) * kBN;
    x.masked = x.col0 + kBN > job.nc;
    const int next = u + 2;  // this warpgroup's next unit
    const int rn = next / job.per_row, cn = next - rn * job.per_row;
    x.ends_run = next >= u_end || rn != x.r || cn >= kNa * job.ntile || cn / job.ntile != x.anchor;
  }
  return x;
}

// a consumer thread's view of a unit: MT m-tiles of 64 rows; in each, rows
// g and g + 8 of its warp's 16 and, of each 8-column group j of the
// 128-column tile, columns 8j + 2q and 8j + 2q + 1 (the wgmma accumulator
// layout: acc[mt][4j + 2h + e] is row 64 mt + 16 warp + g + 8h, column
// 8j + 2q + e). Row index i = 2 mt + h.
template <int MT>
struct Fold {
  const float* bias_s;  // (3 ncp) class biases, then 128 box/coefficient biases
  __nv_bfloat16* y5;
  __nv_bfloat16* coef;
  unsigned long long* keys;
  int row_in_wg;  // 16 warp + g
  int q;
  float best[2 * MT];  // each row's max over the run's tiles so far
  int arg[2 * MT];     // and its class column
};

template <int MT>
__device__ __forceinline__ int fold_row(const Unit& x, const Fold<MT>& f, int i) {
  return x.r * 64 * MT + (i >> 1) * 64 + f.row_in_wg + 8 * (i & 1);
}

// a class tile: each logit rounded to bf16 once; per row two chains (even
// and odd column groups, strict > in column order, so each keeps its first
// maximum), merged with ties to the smaller column, then merged into the
// run (strict >: the earlier tile keeps a tie)
template <int MT, bool kMasked>
__device__ __forceinline__ void fold_cls(const float (&acc)[MT][64], const Unit& x, const Job& job,
                                         Fold<MT>& f) {
  const float* b = f.bias_s + x.anchor * job.ncp + x.col0 + 2 * f.q;
  const int lim = job.nc - x.col0 - 2 * f.q;  // columns 8j + e < lim are classes
  float ub[2][2 * MT];
  int ua[2][2 * MT];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) {
      ub[c][i] = -INFINITY;
      ua[c][i] = 0;
    }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j);
    const int c = j & 1;
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) {
      const int mt = i >> 1, h = i & 1;
      const __nv_bfloat162 v2 = __float22bfloat162_rn(
          make_float2(acc[mt][4 * j + 2 * h] + bb.x, acc[mt][4 * j + 2 * h + 1] + bb.y));
      const uint32_t bits = *reinterpret_cast<const uint32_t*>(&v2);
      const float lo = __uint_as_float(bits << 16), hi = __uint_as_float(bits & 0xffff0000u);
      if ((!kMasked || 8 * j < lim) && lo > ub[c][i]) {
        ub[c][i] = lo;
        ua[c][i] = 8 * j;
      }
      if ((!kMasked || 8 * j + 1 < lim) && hi > ub[c][i]) {
        ub[c][i] = hi;
        ua[c][i] = 8 * j + 1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    if (beats(ub[1][i], ua[1][i], ub[0][i], ua[0][i])) {
      ub[0][i] = ub[1][i];
      ua[0][i] = ua[1][i];
    }
    if (ub[0][i] > f.best[i]) {
      f.best[i] = ub[0][i];
      f.arg[i] = x.col0 + 2 * f.q + ua[0][i];
    }
  }
}

// the box tile, stored: y5 (15 columns) and coef (3 nm)
template <int MT>
__device__ __forceinline__ void fold_box(const float (&acc)[MT][64], const Unit& x, const Job& job,
                                         Fold<MT>& f) {
  const float* b = f.bias_s + kNa * job.ncp;
  const int ncoef = kNa * job.nm;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * f.q;
    const float2 bb = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) {
      const int mt = i >> 1, h = i & 1;
      const int row = fold_row(x, f, i);
      if (row >= job.m) continue;
      const __nv_bfloat162 v = __float22bfloat162_rn(
          make_float2(acc[mt][4 * j + 2 * h] + bb.x, acc[mt][4 * j + 2 * h + 1] + bb.y));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = col + e;
        const __nv_bfloat16 ve = e ? v.y : v.x;
        if (cc < kBox)
          f.y5[(size_t)row * kBox + cc] = ve;
        else if (cc < kBox + ncoef)
          f.coef[(size_t)row * ncoef + (cc - kBox)] = ve;
      }
    }
  }
}

// the end of a run: merge the four lanes of each row, fold the result into
// the keys, and start afresh
template <int MT>
__device__ __forceinline__ void flush_run(const Unit& x, const Job& job, Fold<MT>& f) {
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, f.best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, f.arg[i], off);
      if (beats(ov, oi, f.best[i], f.arg[i])) {
        f.best[i] = ov;
        f.arg[i] = oi;
      }
    }
    const int row = fold_row(x, f, i);
    if (f.q == 0 && row < job.m)
      atomicMax(f.keys + (size_t)row * kNa + x.anchor, class_key(f.best[i], f.arg[i]));
    f.best[i] = -INFINITY;
    f.arg[i] = 0x7fffffff;
  }
}

// MT m-tiles of 64 rows a unit (BM = 64 MT). Three warpgroups: two consumer
// warpgroups take the block's units in turns (ping-pong), one producer
// warpgroup whose first thread issues every copy.
template <int MT>
__global__ void __launch_bounds__(384, 1)
    detect_head_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_wcls,
                       const __grid_constant__ CUtensorMap tm_w5c, const float* __restrict__ bcls,
                       const float* __restrict__ b5c, __nv_bfloat16* __restrict__ y5,
                       __nv_bfloat16* __restrict__ coef, unsigned long long* __restrict__ keys,
                       const Job job) {
  constexpr int kBM = 64 * MT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* base = smem_raw + pad;
  const uint32_t a_smem = raw + pad;
  const uint32_t ring = a_smem + kBM * job.cin * 2;
  float* bias_s = reinterpret_cast<float*>(base + kBM * job.cin * 2 + job.stages * kChunkB);
  const int n_bias = kNa * job.ncp + kOther;
  const uint32_t bars = smem_u32(bias_s + n_bias);
  const uint32_t full = bars, empty = bars + 8 * kMaxStages;
  const uint32_t a_full = bars + 16 * kMaxStages, a_empty = a_full + 8;
  const uint32_t turn = a_empty + 8;  // turn[w]: warpgroup w may issue its products

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < job.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the four warps of the warpgroup that read the stage
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, 8);  // the eight consumer warps
    mbar_init(turn, 4);
    mbar_init(turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's share of the unit list
  const int u0 = (int)((long long)job.units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)job.units * (blockIdx.x + 1) / gridDim.x);

  if (warp >= 8) {
    // producer warpgroup: it gives up registers for the consumers'
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 8 || lane != 0) return;
    int stage = 0, cur_r = -1;
    uint32_t phase = 0, a_phase = 0;
    for (int u = u0; u < u1; ++u) {
      const int r = u / job.per_row, c = u % job.per_row;
      if (r != cur_r) {
        if (cur_r >= 0) {
          mbar_wait(a_empty, a_phase);
          a_phase ^= 1;
        }
        mbar_expect_tx(a_full, kBM * job.cin * 2);
        for (int k = 0; k < job.kc; ++k)
          tma_load(a_smem + k * kBM * 128, &tm_x, a_full, k * kBK, r * kBM);
        cur_r = r;
      }
      const bool is_cls = c < kNa * job.ntile;
      const CUtensorMap* tm = is_cls ? &tm_wcls : &tm_w5c;
      const int n0 = is_cls ? (c / job.ntile) * job.ncp + (c % job.ntile) * kBN : 0;
      for (int k = 0; k < job.kc; ++k) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, kChunkB);
        tma_load(ring + stage * kChunkB, tm, full + 8 * stage, k * kBK, n0);
        if (++stage == job.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: stage the biases, then take every second unit
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  for (int i = tid; i < n_bias; i += 256)
    bias_s[i] = i < kNa * job.ncp ? bcls[i] : b5c[i - kNa * job.ncp];
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  const int wg = warp >> 2;
  Fold<MT> f;
  f.bias_s = bias_s;
  f.y5 = y5;
  f.coef = coef;
  f.keys = keys;
  f.row_in_wg = (warp & 3) * 16 + (lane >> 2);
  f.q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    f.best[i] = -INFINITY;
    f.arg[i] = 0x7fffffff;
  }
  const int r_first = u0 / job.per_row;
  const int n_rows = u1 > u0 ? (u1 - 1) / job.per_row - r_first + 1 : 0;
  int released = 0;  // feature tiles, from the block's first, this warpgroup handed back
  int have = -1;     // the feature tile it last waited for
  // hand back the tiles before `upto`. A warpgroup waits for a tile's load
  // before handing it back, also a tile it takes no unit of, so its arrivals
  // never run ahead of the producer's phase: 8 arrivals of one warpgroup
  // (two tiles at once) would otherwise complete a phase while the other's
  // products on that tile are still in flight, and the next load would land
  // on them
  auto hand_back = [&](int upto) {
    for (; released < upto; ++released) {
      if (released > have) {
        mbar_wait(a_full, released & 1);
        have = released;
      }
      if (lane == 0) mbar_arrive(a_empty);
    }
  };
  uint32_t turn_phase = 0;
  float acc[MT][64];
  for (int u = u0 + wg; u < u1; u += 2) {
    const Unit x = decode_unit(u, u1, job);
    const int tile = x.r - r_first;
    hand_back(tile);  // tiles before this unit's: done with, or never read
    if (u != u0) {  // the other warpgroup has queued its unit's products
      mbar_wait(turn + 8 * wg, turn_phase);
      turn_phase ^= 1;
    }
    if (tile != have) {
      mbar_wait(a_full, tile & 1);
      have = tile;
    }
    const int g = (u - u0) * job.kc;  // the block's chunk index of this unit's first chunk
    int stage = g % job.stages;
    uint32_t phase = (g / job.stages) & 1;
    int prev = -1;
    for (int k = 0; k < job.kc; ++k) {
      mbar_wait(full + 8 * stage, phase);
      const uint64_t db = sw128_desc(ring + stage * kChunkB);
      const uint32_t a_k = a_smem + k * kBM * 128;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_m64n128k16(acc[mt], sw128_desc(a_k + mt * 64 * 128) + 2 * kk, db + 2 * kk,
                           (k | kk) != 0);
      wgmma_commit();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      if (k > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == job.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // hand the tensor cores to the other warpgroup, finish, and fold while
    // the other warpgroup's products run
    if (lane == 0) mbar_arrive(turn + 8 * (1 - wg));
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    hand_back(u + 2 < u1 ? (u + 2) / job.per_row - r_first : n_rows);
    if (x.anchor < 0) {
      fold_box(acc, x, job, f);
    } else {
      if (x.masked)
        fold_cls<MT, true>(acc, x, job, f);
      else
        fold_cls<MT, false>(acc, x, job, f);
      if (x.ends_run) flush_run(x, job, f);
    }
  }
}

__global__ void decode_keys(const unsigned long long* __restrict__ keys, float* __restrict__ cls_max,
                            int* __restrict__ cls_arg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  cls_max[i] = __uint_as_float(u);
  cls_arg[i] = (int)(0xFFFFFFFFu - (uint32_t)key);
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

// a (rows, cols) row-major bf16 tensor, read in boxes of 64 columns x box_rows
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_wcls, const CUtensorMap& tm_w5c,
           const void* bcls, const void* b5c, void* y5, void* coef, void* keys, const Job& job,
           int grid, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = kSmemMax;  // the most any (Cin, ncp) this block shape takes
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        detect_head_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t need = smem_bytes(MT, job.cin, job.ncp, job.stages);
  detect_head_kernel<MT><<<grid, 384, need, stream>>>(
      tm_x, tm_wcls, tm_w5c, (const float*)bcls, (const float*)b5c, (__nv_bfloat16*)y5,
      (__nv_bfloat16*)coef, (unsigned long long*)keys, job);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, Cin) bf16; wcls (3, ncp, Cin) bf16 and bcls (3, ncp) fp32, the class
// columns of each anchor; w5c (128, Cin) bf16 and b5c (128,) fp32, the packed
// box/objectness and coefficient columns; outputs y5 (M, 3, 5) and coef
// (M, 3, nm) bf16, cls_max (M, 3) fp32, cls_arg (M, 3) int32; keys (M, 3)
// 64-bit scratch. All contiguous and 16-byte aligned; Cin % 64 == 0, ncp %
// 128 == 0, 0 < nc <= ncp, 15 + 3 nm <= 128. block_rows is 128 or 64
// positions per block, and the block's shared memory (detect_head.py's
// smem_bytes) must fit in 227 KB; grid is the most blocks to launch (one an
// SM). Zeroes the keys, launches the kernel, then decodes the keys. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the kernel does not take or tensor maps cuTensorMapEncodeTiled
// refuses.
extern "C" int objcavit_detect_head(const void* x, const void* wcls, const void* bcls,
                                    const void* w5c, const void* b5c, void* y5, void* coef,
                                    void* cls_max, void* cls_arg, void* keys, int m, int cin,
                                    int nc, int ncp, int nm, int block_rows, int grid,
                                    void* stream) {
  if (m == 0) return (int)cudaSuccess;
  const int mt = block_rows / 64;
  if ((block_rows != 64 && block_rows != 128) || cin <= 0 || cin % kBK || ncp <= 0 ||
      ncp % kBN || nc <= 0 || nc > ncp || kBox + kNa * nm > kOther || grid <= 0 ||
      smem_bytes(mt, cin, ncp, kMinStages) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_fn();
  if (!encode) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_wcls, tm_w5c;
  if (!make_map(encode, &tm_x, x, m, cin, block_rows) ||
      !make_map(encode, &tm_wcls, wcls, kNa * ncp, cin, kBN) ||
      !make_map(encode, &tm_w5c, w5c, kOther, cin, kBN))
    return (int)cudaErrorInvalidValue;
  Job job;
  job.m = m;
  job.cin = cin;
  job.nc = nc;
  job.ncp = ncp;
  job.nm = nm;
  job.kc = cin / kBK;
  job.ntile = ncp / kBN;
  job.per_row = kNa * job.ntile + 1;
  job.units = (m + block_rows - 1) / block_rows * job.per_row;
  const size_t spare = kSmemMax - smem_bytes(mt, cin, ncp, 0);
  job.stages = spare / kChunkB < (size_t)kMaxStages ? (int)(spare / kChunkB) : kMaxStages;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(keys, 0, (size_t)m * kNa * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = job.units < grid ? job.units : grid;
  const int rc = mt == 2 ? launch<2>(tm_x, tm_wcls, tm_w5c, bcls, b5c, y5, coef, keys, job, blocks, s)
                          : launch<1>(tm_x, tm_wcls, tm_w5c, bcls, b5c, y5, coef, keys, job, blocks, s);
  if (rc != 0) return rc;
  const int n = m * kNa;
  decode_keys<<<(n + 255) / 256, 256, 0, s>>>((const unsigned long long*)keys, (float*)cls_max,
                                              (int*)cls_arg, n);
  return (int)cudaGetLastError();
}
