// Fused MBConv head: 1x1 expand -> SiLU -> kxk depthwise -> SiLU -> SE pool.
//
// Replaces two TPU kernels:
//   * objcavit_tpu/ops/mbconv_pallas.py::mbconv_expand_dw_pool (_kernel), the
//     EfficientNet MBConv body of fused_mbconv_head=True, on NHWC tensors
//     (kernel 8: mbconv_kernel below);
//   * objcavit_tpu/ops/mbconv_bs.py::mbconv_bs_expand_dw_pool (_kernel), the
//     same on (H, W, B, C) tensors (kernel 9: the same kernel, another
//     tensor map).
// The depthwise conv without the expand (kernel 10) is csrc/dw_silu_pool.cu.
//
//   e    = silu(x @ we + be), zeroed outside the image, rounded to bf16
//   y    = silu(sum_ij e[h+i-p, w+j-p] * wd[i, j] + bd)     SAME, stride 1
//   pool = sum_hw y, from the fp32 y before its bf16 rounding
//
// x (Cin channels) and y (M channels) are bf16 with the channel dimension
// contiguous and the batch, row and column strides given in elements; we is
// (Cin, M) bf16, wd (k*k, M) bf16, be and bd (M,) fp32, pool (B, M) fp32.
//
// What bounds it on the H100: bytes. At EfficientNet-B5's stride-1 blocks
// (480x640, batch 8) it reads Cin and writes M = 6 Cin channels a pixel and
// does 2 Cin M + 2 k^2 M flops on it: ~2 flops per byte for the depthwise
// on the CUDA cores and ~Cin/4 per byte for the expand on the tensor cores,
// both under the card's balance point. The unfused route writes and reads
// the expanded tensor about 15 times; this kernel never writes it.
//
// Kernel 8's design, for Hopper (kernels/mbconv.py::mbconv_plan sizes it).
// A work item is a slab of 64 channels, one image, a column strip of SW
// output columns (the whole width where the plan finds that cheapest) and
// a segment of output rows. A persistent grid of one block an SM takes an
// equal, contiguous share of the items in slab-major order, so a block
// loads a slab's weights once or twice and its pipeline runs on from one
// item into the next. Per item it walks the band of input rows (SW + 2p
// columns, p = k / 2) a group of G rows at a time. The five things that held
// the first port's 8x16x48 tiles back, and what this design does about each:
//   1. x re-read once per 48-channel slab, haloed, through L2 (12x-164x x's
//      bytes): x is read once per 64-channel slab, by TMA
//      (cp.async.bulk.tensor on a 4-D tensor map: a box of 64 channels x
//      band x G rows a K chunk, out-of-image pixels zero-filled), with the
//      vertical halo once per segment. Thread-block clusters of the slabs
//      of one strip, one block multicasting x to the cluster, were built
//      and measured: the cluster's lockstep (a stage is refilled once every
//      block has read it) cost more than the L2 traffic it saved (5.55
//      against 4.19 ms a forward; PERF.md), so no cluster is used.
//   2. the expand's waste: each input row is expanded once into a ring of 4G
//      expanded rows in shared memory (bf16, the TPU kernel's rounding
//      point, mbconv_pallas.py:118), so the vertical halo is expanded once
//      per segment, not once per 8 output rows; a strip of the whole width
//      expands no halo column inside the image.
//   3. phases in series: the warps are specialised. Two expand warpgroups
//      take the band groups in turns (even, odd): each runs a group's
//      products on wgmma and writes it into the ring while seven depthwise
//      warps compute the output rows of earlier groups from it. mbarriers
//      hand each ring slot over (ready: an expand warpgroup wrote it;
//      freed: the depthwise warps read it), so the expand runs up to three
//      groups ahead. A producer warp keeps the next groups' TMA loads in
//      flight (a stage holds a whole group; a full and an empty mbarrier a
//      stage). The expand's epilogue adds be, applies SiLU and zeroes the
//      band outside the image (its zero padding would expand to silu(be)
//      != 0).
//   4. mma.sync from ldmatrix: the expand is wgmma.mma_async m64n64k16 (bf16
//      in, fp32 accumulate) with both operands K-major in 128-byte-swizzled
//      shared memory: x as TMA lands it, the weight slab swizzled by the
//      block once; Cin in 16-deep steps over whole 64-channel chunks (TMA
//      and the slab zero past Cin). One block of 16 warps an SM (4 a
//      scheduler): at most 128 registers a thread, none spilled. A 17th
//      warp caps them at 96 (an SM partition's 16,384 registers over 5
//      warps), and they spilled.
//   5. the second launch and the pool: each depthwise lane owns a channel
//      pair; its fp32 sums run over an item's outputs in a fixed order and
//      the seven warps' sums add in warp order. Where one item covers an
//      image (at B5's 30x40 k3 and 15x20 k3 blocks) the block writes the
//      pool itself and there is no second launch; else each item writes its
//      partial and a second kernel adds them in order. No atomics: y and the pool
//      are the same on every run.
// The row-window form (spatial serving, objcavit_torch/parallel/spatial.py):
// x is a band of the image with the k / 2 rows above and below it that lie
// in the image, as one tensor, and the kernel writes and pools only the
// output rows [row_lo, row_hi) of that tensor, the band's. The segments
// cover the window alone; the band groups reach k / 2 rows past it, into
// the halo rows, which the expand reads as any other row. Past the tensor
// TMA fills zeros and the epilogue zeroes the expanded rows, which is the
// image's own zero padding at an edge band: the halo holds every row an
// inner band's taps reach. y holds the window's rows alone.
// A depthwise item is one output row, 8 columns and the warp's 64 channels
// (a channel pair a lane): it reads k rows of 8 + 2p expanded pixels once
// each, as bf16 pairs (128 bytes a pixel, conflict-free at the ring's
// 144-byte pixel stride), and adds each into the outputs it touches, each
// sum in the TPU kernel's tap order.

#include "hopper_common.cuh"

namespace {

// ================================================= kernel 8 (and 9): Hopper

constexpr int kSlab = 64;        // channels a work item: a channel pair a lane
constexpr int kKChunk = 64;      // input channels a TMA box: 128-byte rows
constexpr int kTileBytes = 64 * 128;  // a 64-row tile of one K chunk
constexpr int kRingGroups = 4;  // even, as the stages: see the kernel's note on phases
constexpr int kRingPix = 144;    // bytes of a ring pixel: 128 + 16 against bank conflicts
constexpr int kRun = 8;          // output columns a depthwise item
constexpr int kDwWarps = 7;
// two expand warpgroups in turns, the depthwise warps, a producer warp:
// 16 warps, up to 128 registers a thread
constexpr int kExpandWgs = 2;
constexpr int kExpandThreads = 128 * kExpandWgs;
constexpr int kThreads = kExpandThreads + 32 * kDwWarps + 32;
constexpr int kMaxStages = 4;
constexpr size_t kSmemLimit = 232448;
// phases a build leaves out, for utils/mbconv_ab.py's --split: 1 the
// expand's epilogue (SiLU and the ring's writes), 2 the depthwise (0: none)
#ifndef OBJCAVIT_MBCONV_SKIP
#define OBJCAVIT_MBCONV_SKIP 0
#endif
constexpr int kSkip = OBJCAVIT_MBCONV_SKIP;

struct Plan {
  int nb, h, w, cin, m;
  int row_lo, h_out;  // the output window: rows [row_lo, row_lo + h_out) of x's h
  int strip_w, band_w, g, seg_groups, segments, strips;
  int kchunks, stages, with_pool, direct_pool;
  int items;  // (slab, image, strip, segment) work items, slab-major
  long long ysb, ysh, ysw;
  int batch_minor;
};

// kernels/mbconv.py::smem_bytes: 1024 bytes of alignment, then the x
// stages (a group's row tiles of every K chunk each), the weight slab, the
// ring (and RUN pixels of slack for the last run's reads), the depthwise
// warps' pool sums, two mbarriers a stage and two a ring slot
__host__ __device__ inline size_t smem_bytes(int band_w, int g, int kchunks, int stages) {
  const int mtiles = (g * band_w + 63) / 64;
  return 1024 + (size_t)stages * mtiles * kchunks * kTileBytes + (size_t)kchunks * kTileBytes +
         ((size_t)kRingGroups * g * band_w + kRun) * kRingPix + kDwWarps * kSlab * 4 + 16 * stages +
         16 * kRingGroups;
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
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major smem) @ B (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// work item i of the slab-major order: its slab, image, strip and segment,
// and the segment's first output row and output groups
struct Item {
  int slab, b, unit, w0, r0, n_groups;
};

__device__ __forceinline__ Item decode_item(int i, const Plan& P) {
  Item it;
  const int per_slab = P.nb * P.strips * P.segments;
  it.slab = i / per_slab;
  const int rest = i % per_slab;
  it.b = rest / (P.strips * P.segments);
  it.unit = rest % (P.strips * P.segments);
  it.w0 = (it.unit / P.segments) * P.strip_w;
  it.r0 = P.row_lo + (it.unit % P.segments) * P.seg_groups * P.g;
  it.n_groups = min(P.seg_groups, (P.row_lo + P.h_out - it.r0 + P.g - 1) / P.g);
  return it;
}

// K: the depthwise size; MT: 64-pixel row tiles of a group (G * band_w <=
// 64 MT). A persistent grid: block c takes the work items [c T / grid,
// (c + 1) T / grid) of the T in slab-major order.
template <int K, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    mbconv_kernel(const __grid_constant__ CUtensorMap tm_x, const bf16* __restrict__ we,
                  const float* __restrict__ be, const bf16* __restrict__ wd,
                  const float* __restrict__ bd, bf16* __restrict__ y,
                  float* __restrict__ partial, float* __restrict__ pool, const Plan P) {
  constexpr int kP = K / 2;
  constexpr int kNv = kRun + 2 * kP;  // expanded pixels a run reads of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* base = smem_raw + pad;
  const uint32_t stage0 = raw + pad;
  const uint32_t chunk_bytes = MT * kTileBytes;  // a group's row tiles of one K chunk
  const uint32_t stage_bytes = chunk_bytes * P.kchunks;  // a whole group
  unsigned char* we_s = base + P.stages * stage_bytes;
  const uint32_t we_smem = stage0 + P.stages * stage_bytes;
  unsigned char* ring = we_s + P.kchunks * kTileBytes;
  const int gpix = P.g * P.band_w;  // pixels of a group
  float* pool_s = reinterpret_cast<float*>(ring + ((size_t)kRingGroups * gpix + kRun) * kRingPix);
  const uint32_t full = smem_addr(pool_s + kDwWarps * kSlab);
  const uint32_t empty = full + 8 * P.stages;
  const uint32_t ready = empty + 8 * P.stages;  // ring slot r holds its group
  const uint32_t freed = ready + 8 * kRingGroups;  // ring slot r is read

  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, provably uniform, so the products stay out of divergent code
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int item0 = (int)((long long)P.items * blockIdx.x / gridDim.x);
  const int item1 = (int)((long long)P.items * (blockIdx.x + 1) / gridDim.x);
  const uint32_t group_bytes = (uint32_t)gpix * 128 * P.kchunks;

  if (tid == 0) {
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive with the bytes to come
      mbar_init(empty + 8 * s, 4);  // the warps of the expand warpgroup that read it
    }
    for (int r = 0; r < kRingGroups; ++r) {
      mbar_init(ready + 8 * r, 4);  // the warps of the expand warpgroup that wrote it
      mbar_init(freed + 8 * r, kDwWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the same items and numbers their band groups in one
  // sequence gi: stage gi % stages, ring slot gi % 4, expand warpgroup gi % 2.
  // The stages and the ring slots are even in number, so each belongs to one
  // expand warpgroup, which waits for its barriers' phases in order: an
  // mbarrier's parity wait cannot tell a phase from the one two before it,
  // and a slot shared by both warpgroups let one wait on a barrier two
  // phases behind (a race seen on the card with 3 stages and 3 slots).
  if (tid >= kThreads - 32) {
    // the producer warp: its first lane keeps the stages full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x))
                   : "memory");
      int gi = 0;
      for (int i = item0; i < item1; ++i) {
        const Item it = decode_item(i, P);
        for (int e = 0; e <= it.n_groups; ++e, ++gi) {
          const int st = gi % P.stages;
          if (gi >= P.stages)  // the expand has read group gi - stages
            mbar_wait(empty + 8 * st, ((gi / P.stages) - 1) & 1);
          mbar_expect_tx(full + 8 * st, group_bytes);
          const int col = it.w0 - kP, row = it.r0 - kP + e * P.g;
          for (int kc = 0; kc < P.kchunks; ++kc) {
            const uint32_t dst = stage0 + st * stage_bytes + kc * chunk_bytes;
            if (P.batch_minor)
              tma_load_4d(dst, &tm_x, full + 8 * st, kc * kKChunk, it.b, col, row);
            else
              tma_load_4d(dst, &tm_x, full + 8 * st, kc * kKChunk, col, row, it.b);
          }
        }
      }
    }
  } else if (wg < kExpandWgs) {
    // the expand warpgroups, in turns: warpgroup 0 takes the even band
    // groups, 1 the odd ones, each into ring slot gi % 4
    const int warp = (tid >> 5) & 3, g = lane >> 2, q = lane & 3;
    float bias[16];
    int gi = 0, slab = -1;
    for (int i = item0; i < item1; ++i) {
      const Item it = decode_item(i, P);
      const int m0 = it.slab * kSlab;
      if (it.slab != slab) {
        // a new slab of weights, once both warpgroups are done with the old
        // one: K-major and 128-byte swizzled as wgmma reads it, channel n of
        // the slab, input channel k at chunk k / 64, row n, 16-byte unit
        // ((k % 64) / 8) ^ (n % 8); zero past Cin and past M
        asm volatile("bar.sync 3, %0;\n" ::"n"(kExpandThreads) : "memory");
        const int units = P.kchunks * kKChunk * (kSlab / 8);
        for (int i0 = tid; i0 < units; i0 += 4 * kExpandThreads) {
          uint4 v[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int u = i0 + t * kExpandThreads, k = u / (kSlab / 8), n8 = (u % (kSlab / 8)) * 8;
            v[t] = make_uint4(0, 0, 0, 0);
            if (u < units && k < P.cin && m0 + n8 < P.m)
              v[t] = __ldg(reinterpret_cast<const uint4*>(we + (long long)k * P.m + m0 + n8));
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int u = i0 + t * kExpandThreads, k = u / (kSlab / 8), n8 = (u % (kSlab / 8)) * 8;
            if (u >= units) break;
            const bf16* e = reinterpret_cast<const bf16*>(&v[t]);
            unsigned char* chunk = we_s + (k / kKChunk) * kTileBytes;
            const int kl = k % kKChunk;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int n = n8 + c;
              *reinterpret_cast<bf16*>(chunk + n * 128 + (((kl >> 3) ^ (n & 7)) << 4) +
                                       (kl & 7) * 2) = e[c];
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 3, %0;\n" ::"n"(kExpandThreads) : "memory");
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ch = m0 + 8 * j + 2 * q;
          bias[2 * j] = ch < P.m ? __ldg(be + ch) : 0.0f;
          bias[2 * j + 1] = ch < P.m ? __ldg(be + ch + 1) : 0.0f;
        }
        slab = it.slab;
      }
      for (int e = 0; e <= it.n_groups; ++e, ++gi) {
        if (gi % kExpandWgs != wg) continue;
        const int st = gi % P.stages;
        mbar_wait(full + 8 * st, (gi / P.stages) & 1);
        float acc[MT][32];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        wgmma_fence();
        // every K chunk in 16-deep steps; channels past Cin are zero in x's
        // boxes and in the slab
        for (int kc = 0; kc < P.kchunks; ++kc) {
          const uint32_t a = stage0 + st * stage_bytes + kc * chunk_bytes;
          const uint64_t db = sw128_desc(we_smem + kc * kTileBytes);
#pragma unroll
          for (int kk = 0; kk < kKChunk / 16; ++kk)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              wgmma_m64n64k16(acc[mt], sw128_desc(a + mt * kTileBytes) + 2 * kk, db + 2 * kk,
                              (kc | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);  // the stage is read
        // ring slot gi % 4 is free once the depthwise is done with group gi - 4
        const int slot_i = gi % kRingGroups;
        if (gi >= kRingGroups) mbar_wait(freed + 8 * slot_i, ((gi / kRingGroups) - 1) & 1);
        if (!(kSkip & 1)) {
          // epilogue: accumulator (mt, j, h, e) is group pixel mt 64 + 16
          // warp + g + 8 h, slab channel 8 j + 2 q + e
          unsigned char* slot = ring + (size_t)slot_i * gpix * kRingPix;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int px = mt * 64 + 16 * warp + g + 8 * hh;
              if (px >= gpix) continue;
              const int row = it.r0 - kP + e * P.g + px / P.band_w;
              const int col = it.w0 - kP + px % P.band_w;
              const bool inside = row >= 0 && row < P.h && col >= 0 && col < P.w;
              uint32_t* dst = reinterpret_cast<uint32_t*>(slot + (size_t)px * kRingPix) + q;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                float v0 = 0.0f, v1 = 0.0f;
                if (inside) {
                  v0 = silu(acc[mt][4 * j + 2 * hh] + bias[2 * j]);
                  v1 = silu(acc[mt][4 * j + 2 * hh + 1] + bias[2 * j + 1]);
                }
                const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
                dst[4 * j] = *reinterpret_cast<const uint32_t*>(&v);
              }
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + 8 * slot_i);
      }
    }
  } else {
    // the depthwise warps: output group d of an item from its band groups
    // d and d + 1, one item (row, run of 8 columns) at a time, lane =
    // channel pair m0 + 2 lane
    const int dw = (tid - kExpandThreads) >> 5;
    const int runs = (P.strip_w + kRun - 1) / kRun;
    const int items = P.g * runs;
    float2 wr[K * K], bias = make_float2(0.0f, 0.0f);
    int gi = 0, slab = -1;
    for (int i = item0; i < item1; ++i) {
      const Item it = decode_item(i, P);
      const int ch = it.slab * kSlab + 2 * lane;
      const bool live = ch < P.m;
      if (it.slab != slab) {
#pragma unroll
        for (int t = 0; t < K * K; ++t)
          wr[t] = live ? unpack(__ldg(reinterpret_cast<const uint32_t*>(wd + (long long)t * P.m +
                                                                        ch)))
                       : make_float2(0.0f, 0.0f);
        bias = live ? make_float2(__ldg(bd + ch), __ldg(bd + ch + 1)) : make_float2(0.0f, 0.0f);
        slab = it.slab;
      }
      bf16* yb = y + it.b * P.ysb + ch;
      float2 psum = make_float2(0.0f, 0.0f);
      for (int d = 0; d < it.n_groups; ++d) {
        // output group d reads band groups gi + d and gi + d + 1
        if (d == 0) mbar_wait(ready + 8 * (gi % kRingGroups), (gi / kRingGroups) & 1);
        const int gn = gi + d + 1;
        mbar_wait(ready + 8 * (gn % kRingGroups), (gn / kRingGroups) & 1);
        if (!(kSkip & 2)) {
          for (int t0 = dw; t0 < items; t0 += kDwWarps) {
            const int o = t0 / runs, c0 = (t0 % runs) * kRun;
            const int ro = d * P.g + o;  // output row in the segment = its first band row
            if (it.r0 + ro >= P.row_lo + P.h_out) break;  // items run row by row
            float2 acc[kRun];
#pragma unroll
            for (int t = 0; t < kRun; ++t) acc[t] = make_float2(0.0f, 0.0f);
            // tap row i reaches every output in increasing i, so each sum
            // keeps the tap order
#pragma unroll
            for (int r = 0; r < K; ++r) {
              const int bg = gi + (ro + r) / P.g;  // the band group of band row ro + r
              const int px = (bg % kRingGroups) * gpix + ((ro + r) % P.g) * P.band_w + c0;
              const unsigned char* src = ring + (size_t)px * kRingPix + 4 * lane;
              float2 v[kNv];
#pragma unroll
              for (int jj = 0; jj < kNv; ++jj)
                v[jj] = unpack(*reinterpret_cast<const uint32_t*>(src + jj * kRingPix));
#pragma unroll
              for (int t = 0; t < kRun; ++t)
#pragma unroll
                for (int j = 0; j < K; ++j) {
                  acc[t].x += v[t + j].x * wr[r * K + j].x;
                  acc[t].y += v[t + j].y * wr[r * K + j].y;
                }
            }
            const int h = it.r0 + ro - P.row_lo;  // y's row
#pragma unroll
            for (int t = 0; t < kRun; ++t) {
              const int c = c0 + t, w = it.w0 + c;
              if (!live || c >= P.strip_w || w >= P.w) continue;
              const float v0 = silu(acc[t].x + bias.x), v1 = silu(acc[t].y + bias.y);
              *reinterpret_cast<__nv_bfloat162*>(yb + h * P.ysh + w * P.ysw) =
                  __floats2bfloat162_rn(v0, v1);
              psum.x += v0;
              psum.y += v1;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(freed + 8 * ((gi + d) % kRingGroups));
      }
      // the item's last band group is read too
      __syncwarp();
      if (lane == 0) mbar_arrive(freed + 8 * ((gi + it.n_groups) % kRingGroups));
      gi += it.n_groups + 1;
      if (P.with_pool) {
        // the item's pool: the depthwise warps' sums in warp order
        *reinterpret_cast<float2*>(pool_s + dw * kSlab + 2 * lane) = psum;
        asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kDwWarps) : "memory");
        if (dw == 0 && live) {
          float2 sum = make_float2(0.0f, 0.0f);
          for (int k = 0; k < kDwWarps; ++k) {
            const float2 part = *reinterpret_cast<const float2*>(pool_s + k * kSlab + 2 * lane);
            sum.x += part.x;
            sum.y += part.y;
          }
          float* dst = P.direct_pool ? pool + (long long)it.b * P.m + ch
                                     : partial + ((long long)it.unit * P.nb + it.b) * P.m + ch;
          *reinterpret_cast<float2*>(dst) = sum;
        }
        asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kDwWarps) : "memory");
      }
    }
  }
}

// x as a 4-D tensor, channels innermost, read in boxes of 64 channels x
// band_w columns x g rows of one image: NHWC as (C, W, H, B), (H, W, B, C)
// as (C, B, W, H), each dimension by its stride, so the strides rise
bool make_x_map(CUtensorMap* map, const void* x, int nb, int h, int w, int cin, long long xsb,
                long long xsh, long long xsw, int band_w, int g, bool batch_minor) {
  const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  dims[0] = (cuuint64_t)cin;
  box[0] = kKChunk;
  if (batch_minor) {
    dims[1] = nb, dims[2] = w, dims[3] = h;
    strides[0] = xsb * 2, strides[1] = xsw * 2, strides[2] = xsh * 2;
    box[1] = 1, box[2] = band_w, box[3] = g;
  } else {
    dims[1] = w, dims[2] = h, dims[3] = nb;
    strides[0] = xsw * 2, strides[1] = xsh * 2, strides[2] = xsb * 2;
    box[1] = band_w, box[2] = g, box[3] = 1;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int K, int MT>
int launch_mbconv(const CUtensorMap& tm, const void* we, const void* be, const void* wd,
                  const void* bd, void* y, void* partial, void* pool, const Plan& P, int grid,
                  size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mbconv_kernel<K, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  mbconv_kernel<K, MT><<<grid, kThreads, smem, stream>>>(
      tm, (const bf16*)we, (const float*)be, (const bf16*)wd, (const float*)bd, (bf16*)y,
      (float*)partial, (float*)pool, P);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

int mbconv_head(const void* x, const void* we, const void* be, const void* wd, const void* bd,
                void* y, void* partial, void* pool, int nb, int h, int w, int cin, int m,
                int ksize, long long xsb, long long xsh, long long xsw, long long ysb,
                long long ysh, long long ysw, int with_pool, int strip_w, int group_rows,
                int seg_groups, int grid, int stages, long long smem, int row_lo, int row_hi,
                void* stream) {
  if (nb == 0 || h == 0 || w == 0 || m == 0 || row_lo == row_hi) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ksize != 3 && ksize != 5) return (int)cudaErrorInvalidValue;
  if (row_lo < 0 || row_hi < row_lo || row_hi > h) return (int)cudaErrorInvalidValue;
  const int p = ksize / 2;
  Plan P;
  P.nb = nb, P.h = h, P.w = w, P.cin = cin, P.m = m;
  P.row_lo = row_lo, P.h_out = row_hi - row_lo;
  P.strip_w = strip_w, P.band_w = strip_w + 2 * p, P.g = group_rows, P.seg_groups = seg_groups;
  const int groups = group_rows > 0 ? (P.h_out + group_rows - 1) / group_rows : 0;
  P.segments = seg_groups > 0 ? (groups + seg_groups - 1) / seg_groups : 0;
  P.strips = strip_w > 0 ? (w + strip_w - 1) / strip_w : 0;
  P.kchunks = (cin + kKChunk - 1) / kKChunk, P.stages = stages;
  P.with_pool = with_pool;
  P.direct_pool = P.strips * P.segments == 1;
  P.items = (m + kSlab - 1) / kSlab * nb * P.strips * P.segments;
  P.ysb = ysb, P.ysh = ysh, P.ysw = ysw;
  P.batch_minor = xsb < xsw;
  const int mt = (group_rows * P.band_w + 63) / 64;
  if (strip_w <= 0 || strip_w > w || group_rows < 2 * p || seg_groups <= 0 || mt > 2 ||
      P.band_w > 256 || group_rows > 256 || grid <= 0 || grid > P.items || stages < 2 ||
      stages % 2 || stages > kMaxStages || cin <= 0 || cin % 8 || m % 8 ||
      smem != (long long)smem_bytes(P.band_w, group_rows, P.kchunks, stages) ||
      smem > (long long)kSmemLimit || (with_pool && !P.direct_pool && !partial))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!make_x_map(&tm, x, nb, h, w, cin, xsb, xsh, xsw, P.band_w, group_rows, P.batch_minor))
    return (int)cudaErrorInvalidValue;
  int rc;
#define OBJCAVIT_MBCONV_LAUNCH(K, MT) \
  launch_mbconv<K, MT>(tm, we, be, wd, bd, y, partial, pool, P, grid, (size_t)smem, s)
  if (ksize == 3)
    rc = mt == 1 ? OBJCAVIT_MBCONV_LAUNCH(3, 1) : OBJCAVIT_MBCONV_LAUNCH(3, 2);
  else
    rc = mt == 1 ? OBJCAVIT_MBCONV_LAUNCH(5, 1) : OBJCAVIT_MBCONV_LAUNCH(5, 2);
#undef OBJCAVIT_MBCONV_LAUNCH
  if (rc != 0 || !with_pool || P.direct_pool) return rc;
  const int bm = nb * m;
  pool_reduce_kernel<<<(bm + 255) / 256, 256, 0, s>>>((const float*)partial, (float*)pool,
                                                      P.strips * P.segments, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// x: B images of H x W pixels of Cin bf16 channels at element strides (xsb,
// xsh, xsw), channels contiguous: NHWC, or (H, W, B, C) (xsb < xsw); y the
// same with M channels at (ysb, ysh, ysw). wd (k*k, M) bf16, bd (M,) fp32.
// Cin % 8 == 0, M % 8 == 0, strides multiples of 8, pointers 16-byte
// aligned; k is 3 or 5.
// we (Cin, M) bf16 and be (M,) fp32 are the 1x1 expand; strip_w,
// group_rows, seg_groups, grid, stages and smem are
// kernels/mbconv.py::mbconv_plan's (smem must be its smem_bytes); with_pool
// != 0: pool (B, M) fp32 gets the spatial sum of the fp32 y and, unless the
// plan has one strip and one segment, partial is scratch of strips x
// segments x B x M fp32.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a plan the kernel does not take or a tensor map the driver refuses.
extern "C" int objcavit_mbconv_head(const void* x, const void* we, const void* be, const void* wd,
                                    const void* bd, void* y, void* partial, void* pool, int nb,
                                    int h, int w, int cin, int m, int ksize, long long xsb,
                                    long long xsh, long long xsw, long long ysb, long long ysh,
                                    long long ysw, int with_pool, int strip_w, int group_rows,
                                    int seg_groups, int grid, int stages, long long smem,
                                    void* stream) {
  return mbconv_head(x, we, be, wd, bd, y, partial, pool, nb, h, w, cin, m, ksize, xsb, xsh, xsw,
                     ysb, ysh, ysw, with_pool, strip_w, group_rows, seg_groups, grid, stages, smem,
                     0, h, stream);
}

// The row-window form: x holds h rows (an image's band and its halo rows),
// y the output rows [row_lo, row_hi) of them alone (row_hi - row_lo rows at
// y's strides), and the pool sums those rows; the plan is mbconv_plan's for
// row_hi - row_lo rows. 0 <= row_lo <= row_hi <= h; the rest as above.
extern "C" int objcavit_mbconv_head_rows(const void* x, const void* we, const void* be,
                                         const void* wd, const void* bd, void* y, void* partial,
                                         void* pool, int nb, int h, int w, int cin, int m,
                                         int ksize, long long xsb, long long xsh, long long xsw,
                                         long long ysb, long long ysh, long long ysw,
                                         int with_pool, int strip_w, int group_rows,
                                         int seg_groups, int grid, int stages, long long smem,
                                         int row_lo, int row_hi, void* stream) {
  return mbconv_head(x, we, be, wd, bd, y, partial, pool, nb, h, w, cin, m, ksize, xsb, xsh, xsw,
                     ysb, ysh, ysw, with_pool, strip_w, group_rows, seg_groups, grid, stages, smem,
                     row_lo, row_hi, stream);
}
