// Fused 1x1 conv + softmax over bins + expectation over bin centres.
//
// Replaces the TPU kernel objcavit_tpu/ops/pallas_bins.py::
// fused_conv_bins_depth_batched (_fwd_conv_batched_kernel), the factored bins
// head of GraphBins inference (objcavit_tpu/ops/bins.py:145-157):
//
//   depth[b, s] = sum_k softmax_k(x[b, s, :] @ W_b + bias)_k * centers[b, k]
//
// x is (B, S, C) bf16, W_b = queries_b^T @ conv_out is (C, K=256) bf16 per
// image, bias (K,) and centers (B, K) are fp32, depth (B, S) is fp32. The
// (B, S, K) logits never reach device memory; they stay fp32, and the max,
// the exps and the sums are fp32. The weight's batch stride is an argument,
// so a stride of 0 serves one shared W (the TPU's fused_conv_bins_depth,
// kernel 3).
//
// What bounds it on the H100, at the flagship's (B 8, S 240 x 320 = 76,800,
// C 128): the stated bound is bytes, 157.3 MB of x read once, 0.0478 ms at
// 3.35 TB/s. Beside it, three units need about as long: the bf16 products,
// 40.3 GFLOP, 0.041 ms at 989 TFLOP/s; the exps, 157 M on the SFU at 16
// ex2 a clock an SM, ~0.04 ms; the fp32 epilogue, ~5 CUDA-core operations
// a logit, ~0.02 ms. So the kernel gets near its bound only if TMA, the
// tensor cores and the SFU all work at once.
//
// Design, for Hopper. The work is a list of units, one per (image, tile of
// 64 pixels), image-major. A persistent grid of one block an SM takes a
// contiguous, equal share of the list, so a block meets at most one or two
// images at the flagship (a share is ~4,650 pixels of an image's 76,800).
// A block is four warpgroups: a producer and three consumers that take the
// block's units round-robin (two at C 256, where the ring holds only two
// stages). setmaxnreg gives the consumers 152 registers and the producer 40.
// * The producer's first thread loads each unit's x tile (64 pixels x C, in
//   64-channel boxes, 128-byte swizzled, K-major) by TMA into a ring of
//   stages on full/empty mbarriers, as many as shared memory holds (2 at C
//   256, 8 at C <= 128; kernels/bins.py::ring_plan, passed in). It loads
//   W_b by TMA once per image, read in place as an MN-major B operand
//   (four boxes of 64 bins x C rows), and the image's centres by one bulk
//   copy; with a weight stride of 0 it loads W once per block and only the
//   centres per image. TMA's out-of-bounds zero fill covers C that is not a
//   multiple of 64 and the rows past B*S; the
//   rows of a tile past S belong to the next image and are computed but not
//   stored.
// * A consumer takes a unit's 256 bins as two halves of 128: a chain of C /
//   16 wgmma m64n128k16 (bf16 in, fp32 accumulate, B transposed; the first
//   only writes the accumulators), then the half's fold, then the second
//   half into the same 64 registers a thread, then its fold. While one
//   consumer folds, the others' products run: three consumers keep the
//   tensor cores and the SFU busy together better than two in turns.
//   Measured at the flagship (bins_ab, H100): two consumers in turns with
//   one m64n256k16 chain a unit, folded whole, 0.113 ms; two chains of 128
//   with the first folded early, 0.096; three consumers, 0.088.
// * The fold (fold_half): one FFMA a logit, product x log2 e + bias x log2
//   e, into ex2.approx with no max subtracted; sums of e and e * centre in
//   two chains a row; the quad's sums by shuffles; one division. That is 3
//   CUDA-core operations and 1 SFU operation a logit, against 5 and 1 with
//   a max pass and the bias added, and nothing to initialise between units.
//   A row whose sum of e leaves [2^-16, 2^40] (a row whose largest logit
//   is above ~28 or below ~-17 always does) makes its consumer compute the
//   unit's products again and fold them with each row's max subtracted
//   (half_max, half_exact), so the fast path never loses an e that counts;
//   the stage is freed after that check. A warp's 16 depths go out in one
//   64-byte store.
// * No atomics: two calls give the same bits.
//
// What held the mma.sync version back (0.2600 ms at the flagship): loads
// were synchronous (each warp copied its x rows with __ldg and waited), W
// was re-read from shared memory for every 16 pixels (~2.5 GB a call), W
// was staged transposed by 2-byte stores in each of 264 blocks, and the
// softmax ran in the warp that issued the products.

#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda: see encode_fn
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kBM = 64;        // pixels a unit: wgmma's M
constexpr int kBK = 64;        // channels a 128-byte swizzled box
constexpr int kBoxB = kBM * kBK * 2;  // bytes of one x box
constexpr int kMaxStages = 8;
constexpr int kMaxChannels = 256;
constexpr int kConsumers = 3;  // consumer warpgroups; the producer's is the last
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr size_t kSmemMax = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// bytes before the 1024-aligned tiles: bias, bias * log2 e, centres, 18
// barriers
constexpr size_t kHead = 3 * kBins * sizeof(float) + 18 * 8;
// the fast fold's row sums of e must lie in [2^-16, 2^40]; see fold_half
constexpr float kSumLo = 1.52587890625e-05f, kSumHi = 1099511627776.0f;

struct Job {
  int s_len;      // pixels an image
  int c;          // channels
  int kc;         // 64-channel boxes of a tile: ceil(C / 64)
  int ksteps;     // wgmma k-steps of a unit: C / 16
  int tiles;      // units of an image: ceil(S / 64)
  int units;      // B * tiles
  int stages;     // x ring depth
  int consumers;  // consumer warpgroups that take units: at most stages
  int shared_w;   // 1: one W for every image
};

size_t smem_bytes(int c, int stages) {
  const int kc = (c + kBK - 1) / kBK;
  return 1024 + kHead + (size_t)c * kBins * 2 + (size_t)stages * kc * kBoxB;
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

// one box of a 2-D bf16 tensor map into swizzled smem
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes global -> shared, completed on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor, 128-byte swizzle, the tile 1024-byte aligned. K-major
// (x): 128-byte rows of 64 channels, 8-row groups 1024 bytes apart (SBO).
// MN-major (W): 128-byte rows of 64 bins, one a channel; 8-channel groups
// 1024 bytes apart (SBO) and 64-bin chunks `lbo` bytes apart (LBO)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across the async products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, K-major smem) @ B (16 x 128, MN-major smem): a chain's
// first product, which only writes d, so d's registers are free until it
__device__ __forceinline__ void wgmma_m64n128k16_tb_first(float (&d)[64], uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),
        "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),
        "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
        "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]),
        "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]),
        "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]),
        "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]),
        "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A (64 x 16, K-major smem) @ B (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_m64n128k16_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the 4 lanes (q = lane % 4) that hold one pixel row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A consumer thread's view of a unit (the wgmma accumulator layout): half
// h's acc[4j + 2r + e] is the product of row 16 warp + g + 8r of the 64 and
// bin 128h + 8j + 2q + e, before the bias.
//
// The fast fold takes the exps of the logits themselves, with no max
// subtracted: one FFMA a logit, x log2 e + bias log2 e, into ex2.approx,
// then this lane's sums of e and e * centre in two chains a row. It holds
// while a row's sum of e lies in [2^-16, 2^40]: then no e overflows, the
// largest is at least 2^-24, so what flushes to zero weighs under 2^-102 of
// it, and the exponent's rounding (|t| 2^-24 with |t| <= 48 for every e
// above 2^-24 of the largest) moves such an e by under 3e-6 of itself.
// fast_depth's ok says whether both rows' sums do (false on a NaN); if any
// row of the unit fails, the warpgroup folds the unit exactly.
__device__ __forceinline__ void fold_half(const float (&acc)[64], const float* bl_s,
                                          const float* cent_s, int q, float (&se)[2][2],
                                          float (&sc)[2][2]) {
  const float2* b2 = reinterpret_cast<const float2*>(bl_s) + q;
  const float2* c2 = reinterpret_cast<const float2*>(cent_s) + q;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 bl = b2[4 * j], c = c2[4 * j];
    const int k = j & 1;  // two chains a row
    const float p0 = ex2(fmaf(acc[4 * j], kLog2e, bl.x));
    const float p1 = ex2(fmaf(acc[4 * j + 1], kLog2e, bl.y));
    const float p2 = ex2(fmaf(acc[4 * j + 2], kLog2e, bl.x));
    const float p3 = ex2(fmaf(acc[4 * j + 3], kLog2e, bl.y));
    se[0][k] += p0 + p1;
    sc[0][k] = fmaf(p0, c.x, fmaf(p1, c.y, sc[0][k]));
    se[1][k] += p2 + p3;
    sc[1][k] = fmaf(p2, c.x, fmaf(p3, c.y, sc[1][k]));
  }
}

// whether v holds in any thread of consumer warpgroup wg (a named barrier
// of its 128 threads, 2 + wg)
__device__ __forceinline__ bool wg_any(bool v, int wg) {
  uint32_t r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n bar.red.or.pred q, %2, 128, p;\n"
      " selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)v), "r"(2 + wg)
      : "memory");
  return r != 0;
}

// the quad's sums -> the depths of rows g and g + 8; ok as above
__device__ __forceinline__ float2 fast_depth(const float (&se)[2][2], const float (&sc)[2][2],
                                            bool& ok) {
  const float e0 = quad_sum(se[0][0] + se[0][1]), e1 = quad_sum(se[1][0] + se[1][1]);
  ok = e0 >= kSumLo && e0 <= kSumHi && e1 >= kSumLo && e1 <= kSumHi;
  return make_float2(quad_sum(sc[0][0] + sc[0][1]) / e0, quad_sum(sc[1][0] + sc[1][1]) / e1);
}

// one half's row maxima of (product + bias), this thread's 32 columns a row
__device__ __forceinline__ void half_max(const float (&acc)[64], const float* bias_s, int q,
                                         float& mx0, float& mx1) {
  const float2* b2 = reinterpret_cast<const float2*>(bias_s) + q;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = b2[4 * j];
    mx0 = fmaxf(mx0, fmaxf(acc[4 * j] + b.x, acc[4 * j + 1] + b.y));
    mx1 = fmaxf(mx1, fmaxf(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y));
  }
}

// one half's sums of e and e * centre with the row maxima subtracted
__device__ __forceinline__ void half_exact(const float (&acc)[64], const float* bias_s,
                                           const float* cent_s, int q, float m0, float m1,
                                           float (&se)[2], float (&sc)[2]) {
  const float2* b2 = reinterpret_cast<const float2*>(bias_s) + q;
  const float2* c2 = reinterpret_cast<const float2*>(cent_s) + q;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = b2[4 * j], c = c2[4 * j];
    const float p0 = __expf(acc[4 * j] + b.x - m0), p1 = __expf(acc[4 * j + 1] + b.y - m0);
    const float p2 = __expf(acc[4 * j + 2] + b.x - m1), p3 = __expf(acc[4 * j + 3] + b.y - m1);
    se[0] += p0 + p1;
    sc[0] = fmaf(p0, c.x, fmaf(p1, c.y, sc[0]));
    se[1] += p2 + p3;
    sc[1] = fmaf(p2, c.x, fmaf(p3, c.y, sc[1]));
  }
}

// acc = the unit's x tile (A at a_tile) @ the 128 bins of W whose first
// 64-bin chunk is at w_half: C / 16 products, unrolled when KSTEPS > 0
template <int KSTEPS>
__device__ __forceinline__ void products(float (&acc)[64], uint32_t a_tile, uint32_t w_half,
                                         uint32_t chunk_w, int ksteps) {
  wgmma_m64n128k16_tb_first(acc, sw128_desc(a_tile, 16), sw128_desc(w_half, chunk_w));
  if (KSTEPS > 0) {
#pragma unroll
    for (int ks = 1; ks < KSTEPS; ++ks)
      wgmma_m64n128k16_tb(acc, sw128_desc(a_tile + (ks >> 2) * kBoxB, 16) + 2 * (ks & 3),
                          sw128_desc(w_half + ks * 2048, chunk_w));
  } else {
    for (int ks = 1; ks < ksteps; ++ks)
      wgmma_m64n128k16_tb(acc, sw128_desc(a_tile + (ks >> 2) * kBoxB, 16) + 2 * (ks & 3),
                          sw128_desc(w_half + ks * 2048, chunk_w));
  }
}

// kConsumers consumer warpgroups take the block's units round-robin; the
// producer warpgroup's first thread issues every copy. KSTEPS: C / 16 known at
// compile time (the products unrolled), or 0 for a loop over job.ksteps.
template <int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
    conv_bins_depth_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w,
                           const float* __restrict__ bias, const float* __restrict__ centers,
                           float* __restrict__ depth, const Job job) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bias_s = reinterpret_cast<float*>(smem_raw);
  float* bl_s = bias_s + kBins;  // bias * log2 e
  float* cent_s = bl_s + kBins;
  const uint32_t bars = smem_u32(cent_s + kBins);
  const uint32_t full = bars, empty = bars + 8 * kMaxStages;
  const uint32_t img_full = bars + 16 * kMaxStages, img_empty = img_full + 8;
  const uint32_t head_end = smem_u32(smem_raw) + (uint32_t)kHead;
  const uint32_t w_smem = (head_end + 1023) & ~1023u;  // 4 chunks of C x 128 bytes
  const uint32_t chunk_w = (uint32_t)job.c * 128;
  const uint32_t ring = w_smem + 4 * chunk_w;
  const uint32_t stage_b = (uint32_t)job.kc * kBoxB;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < job.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the four warps of the consumer that read the stage
    }
    mbar_init(img_full, 1);
    mbar_init(img_empty, 4 * kConsumers);  // every consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's share of the unit list
  const int u0 = (int)((long long)job.units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)job.units * (blockIdx.x + 1) / gridDim.x);
  const int b0 = u0 / job.tiles;

  if (warp >= 4 * kConsumers) {
    // the producer warpgroup: it gives up registers for the consumers'
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 4 * kConsumers || lane != 0) return;
    int stage = 0, cur_b = -1, cur_w = -1;
    uint32_t phase = 0;
    for (int u = u0; u < u1; ++u) {
      const int b = u / job.tiles, t = u - b * job.tiles;
      if (b != cur_b) {
        if (cur_b >= 0) mbar_wait(img_empty, (cur_b - b0) & 1);  // both consumers are done
        const int wid = job.shared_w ? 0 : b;
        const bool load_w = wid != cur_w;
        mbar_expect_tx(img_full, kBins * 4 + (load_w ? (uint32_t)job.c * kBins * 2 : 0));
        bulk_load(smem_u32(cent_s), centers + (size_t)b * kBins, kBins * 4, img_full);
        if (load_w)
          for (int j = 0; j < 4; ++j)
            tma_load(w_smem + j * chunk_w, &tm_w, img_full, j * 64, wid * job.c);
        cur_b = b;
        cur_w = wid;
      }
      mbar_wait(empty + 8 * stage, phase ^ 1);
      mbar_expect_tx(full + 8 * stage, stage_b);
      const int row = b * job.s_len + t * kBM;
      for (int k = 0; k < job.kc; ++k)
        tma_load(ring + stage * stage_b + k * kBoxB, &tm_x, full + 8 * stage, k * kBK, row);
      if (++stage == job.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: stage the bias, then take every job.consumers-th unit
  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
  if (tid < kBins) {
    bias_s[tid] = bias[tid];
    bl_s[tid] = bias[tid] * kLog2e;
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(128 * kConsumers) : "memory");

  const int wg = warp >> 2;
  const int q = lane & 3;
  const int n_epochs = u1 > u0 ? (u1 - 1) / job.tiles - b0 + 1 : 0;
  // images, from the block's first: those this consumer handed back, and
  // the last whose load it waited for. It waits for every image's load
  // before handing the image back, also one it takes no unit of, so its
  // parity waits never run two loads ahead or behind
  int released = 0;
  int have = -1;
  float acc[64];
  // a consumer waits on a stage's full barrier by parity, so it must not
  // reach a stage two fills ahead: with at least as many stages as
  // consumers, the fill before the one it waits for precedes its last unit's
  for (int u = wg < job.consumers ? u0 + wg : u1; u < u1; u += job.consumers) {
    const int b = u / job.tiles, t = u - b * job.tiles;
    const int e = b - b0;
    for (; released < e; ++released) {  // images it is done with
      if (released > have) {  // one it took no unit of: its load first
        mbar_wait(img_full, released & 1);
        have = released;
      }
      if (lane == 0) mbar_arrive(img_empty);
    }
    if (e != have) {
      mbar_wait(img_full, e & 1);
      have = e;
    }
    const int i = u - u0;
    const int stage = i % job.stages;
    mbar_wait(full + 8 * stage, (i / job.stages) & 1);
    const uint32_t a_tile = ring + stage * stage_b;
    // the two halves of the bins in turn, each a chain of products and its fold
    float se[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wgmma_fence();
      products<KSTEPS>(acc, a_tile, w_smem + 2 * h * chunk_w, chunk_w, job.ksteps);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
      fold_half(acc, bl_s + 128 * h, cent_s + 128 * h, q, se, sc);
    }
    bool ok;
    float2 d = fast_depth(se, sc, ok);
    if (wg_any(!ok, wg)) {
      // rare: a row the fast fold cannot take. The warpgroup computes the
      // unit's products again (the stage is still held), half by half, for
      // each row's max over its 256 logits, then for the sums with it
      // subtracted
      float mx0 = -INFINITY, mx1 = -INFINITY;
      for (int h = 0; h < 2; ++h) {
        wgmma_fence();
        products<KSTEPS>(acc, a_tile, w_smem + 2 * h * chunk_w, chunk_w, job.ksteps);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(acc);
        half_max(acc, bias_s + 128 * h, q, mx0, mx1);
      }
      const float m0 = quad_max(mx0), m1 = quad_max(mx1);
      float se2[2] = {0.f, 0.f}, sc2[2] = {0.f, 0.f};
      for (int h = 0; h < 2; ++h) {
        wgmma_fence();
        products<KSTEPS>(acc, a_tile, w_smem + 2 * h * chunk_w, chunk_w, job.ksteps);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(acc);
        half_exact(acc, bias_s + 128 * h, cent_s + 128 * h, q, m0, m1, se2, sc2);
      }
      d = make_float2(quad_sum(sc2[0]) / quad_sum(se2[0]), quad_sum(sc2[1]) / quad_sum(se2[1]));
    }
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    // lane L < 16 stores row L of the warp's 16: row g + 8h sits in lane 4g
    const float lo = __shfl_sync(0xffffffffu, d.x, (lane & 7) * 4);
    const float hi = __shfl_sync(0xffffffffu, d.y, (lane & 7) * 4);
    const int pix = t * kBM + (warp & 3) * 16 + lane;
    if (lane < 16 && pix < job.s_len) depth[(size_t)b * job.s_len + pix] = lane < 8 ? lo : hi;
  }
  for (; released < n_epochs; ++released) {
    if (released > have) {
      mbar_wait(img_full, released & 1);
      have = released;
    }
    if (lane == 0) mbar_arrive(img_empty);
  }
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

// a (rows, cols) row-major bf16 tensor, read in boxes of 64 columns x
// box_rows, 128-byte swizzled; columns past cols read as zero
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, long long rows, int cols,
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

template <int KSTEPS>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const void* bias,
           const void* centers, void* depth, const Job& job, int blocks, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_bins_depth_kernel<KSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemMax);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  conv_bins_depth_kernel<KSTEPS><<<blocks, kThreads, smem_bytes(job.c, job.stages), stream>>>(
      tm_x, tm_w, (const float*)bias, (const float*)centers, (float*)depth, job);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, C) bf16 contiguous, 0 < C <= 256, C % 16 == 0; w image b at w +
// b * w_bstride elements, each (C, 256) bf16 contiguous, w_bstride C * 256 or
// 0 (one W for the batch); bias (256,) and centers (B, 256) fp32; depth
// (B, S) fp32. x, w and centers 16-byte aligned. grid: the most blocks to
// launch (one an SM). stages and consumers are the ring's plan
// (kernels/bins.py::ring_plan): 1 <= stages <= 8 x tiles beside W in shared
// memory, 1 <= consumers <= min(3, stages). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take or tensor
// maps cuTensorMapEncodeTiled refuses.
extern "C" int objcavit_conv_bins_depth_batched(
    const void* x, const void* w, const void* bias, const void* centers,
    void* depth, int b, int s_len, int c, long long w_bstride,
    int grid, int stages, int consumers, void* stream) {
  if (b == 0 || s_len == 0) return (int)cudaSuccess;
  if (c <= 0 || c > kMaxChannels || c % 16 || grid <= 0 ||
      (w_bstride != 0 && w_bstride != (long long)c * kBins) || stages < 1 ||
      stages > kMaxStages || smem_bytes(c, stages) > kSmemMax || consumers < 1 ||
      consumers > kConsumers || consumers > stages)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_fn();
  if (!encode) return (int)cudaErrorInvalidValue;
  const int shared_w = w_bstride == 0;
  CUtensorMap tm_x, tm_w;
  if (!make_map(encode, &tm_x, x, (long long)b * s_len, c, kBM) ||
      !make_map(encode, &tm_w, w, (long long)(shared_w ? 1 : b) * c, kBins, c))
    return (int)cudaErrorInvalidValue;
  Job job;
  job.s_len = s_len;
  job.c = c;
  job.kc = (c + kBK - 1) / kBK;
  job.ksteps = c / 16;
  job.tiles = (s_len + kBM - 1) / kBM;
  job.units = b * job.tiles;
  job.stages = stages;
  job.consumers = consumers;
  job.shared_w = shared_w;
  const int blocks = job.units < grid ? job.units : grid;
  const cudaStream_t s = (cudaStream_t)stream;
  // the flagship's width and C 64 unrolled; any other C % 16 == 0 loops
  // (unrolled at C 256, the products' descriptors spilled)
  switch (c) {
    case 64:
      return launch<4>(tm_x, tm_w, bias, centers, depth, job, blocks, s);
    case 128:
      return launch<8>(tm_x, tm_w, bias, centers, depth, job, blocks, s);
    default:
      return launch<0>(tm_x, tm_w, bias, centers, depth, job, blocks, s);
  }
}
