// Depthwise conv, bias, SiLU and the optional pool sum, NHWC bf16 (kernel 10).
//
// Replaces the TPU kernel objcavit_tpu/ops/dw_pallas.py::dw_conv_silu_pool
// (_dw_kernel):
//
//   y    = silu(sum_ij x[h+i-p, w+j-p] * wd[i, j] + bd)    SAME, stride 1, k = 3 or 5
//   pool = sum_hw y, from the fp32 y before its bf16 rounding (optional)
//
// each sum in the TPU kernel's order (taps i, then j, from 0, then the
// bias). x and y are (B, H, W, C) bf16, contiguous; wd (k*k, C) bf16, bd (C,)
// fp32, pool (B, C) fp32.
//
// What bounds it on the H100: bytes. It reads x and writes y once, 4 bytes
// a channel of a pixel, for 2 k^2 flops on the CUDA cores (4.5 and 12.5
// flops a byte at k 3 and 5, under the card's 20: 67 TFLOP/s of fp32 over
// 3.35 TB/s). So the design reads every input byte from device memory about
// once and keeps the loads in flight while the taps run. On the card the
// tap warps set the time all the same (PERF.md §6): the loads alone run at
// ~3 TB/s, and of the warps' work the output epilogue (SiLU's two SFU ops a
// value and the stores, which hide each other) costs more than the FMAs.
//
// Design, for Hopper (kernels/mbconv.py::dw_plan sizes it):
// * Work items of (image, 64-channel slab, column strip of SW output
//   columns, segment of SH output rows), segments innermost. A persistent
//   grid of as many blocks as the SMs hold at once takes items i, i + grid,
//   ...; the plan picks strips and segments so that the items fill the SMs
//   evenly (at (8, 15, 20, 1824) one strip and one segment: 232 items on
//   232 blocks, two an SM).
// * Rows stream through a ring. A producer warp issues one TMA load a
//   (item, input row): a box of the slab's 64 channels (128 bytes a pixel)
//   x SW + 2p columns of one input row, on a 4-D tensor map over (C, W, H,
//   B). Its zero fill past the image and past C gives SAME padding and the
//   channel tail (C = 240, 56) with no branch. A full and an empty mbarrier
//   a ring slot; the producer runs ahead across items, so the loads of the
//   next rows (and the next item's) are in flight while the taps run. Each
//   input row is read once an item; the only re-reads are the 2p halo rows
//   at a segment's edge and the 2p halo columns at a strip's edge, mostly
//   from L2, since neighbouring segments run at once on neighbouring blocks.
// * The taps. A lane owns a channel pair (lane 2l, 2l + 1 of the slab), a
//   warp a run of kCpw output columns (at most 8 tap warps a block): its 32
//   lanes read one pixel's 128 bytes at a time, one whole line, so the
//   reads are free of bank conflicts with no swizzle. The lane keeps its
//   k^2 weight pairs in registers, and k rolling accumulator rows for its
//   columns:
//   each input row, read once from shared memory, adds tap row i into the
//   output row it is tap row i of, so a sum gets its taps in the TPU
//   kernel's order; an output row is done (bias, SiLU, a bf16 pair stored,
//   128 bytes a warp) when its last tap row arrives.
// * The pool: a lane's fp32 sums over its outputs, in order; the warps'
//   sums added in warp order in shared memory, one partial an item. Where
//   one item covers an image's slab the block writes the pool; else a
//   second launch adds the partials in order (the block that writes the
//   last partial adding them, after a counter, ran slower: PERF.md §6). No
//   atomics: y and the pool are the same on every run.
//
// What held the first port's kernel back (8 x 16 tiles of 48 channels) and
// what this design does about it: its whole haloed band loaded, then
// computed, with no overlap (here a ring of rows in flight beside the
// taps); 1.41x (k 3) and 1.88x (k 5) of x read for halos (here 2p of SH
// rows and 2p of SW columns); ragged tiles on small maps (here strips and
// segments fitted to the map); 96-byte pixel slices (here 128); the
// weights reloaded per job (here once per slab a block meets).

#include "hopper_common.cuh"

namespace {

constexpr int kSlab = 64;             // channels an item: a channel pair a lane
constexpr int kPixBytes = kSlab * 2;  // a pixel's slab: 128 bytes
constexpr int kMaxWarps = 8;          // tap warps a block, beside the producer warp
constexpr int kMaxStages = 8;         // input rows the ring holds
constexpr size_t kSmemLimit = 232448;

// builds that leave a phase out, for utils/mbconv_ab.py's --dw --split: 1
// the loads alone (no taps, no stores), 2 the taps and stores alone (no
// loads; the producer completes each slot's phase itself)
#ifndef OBJCAVIT_DW_SKIP
#define OBJCAVIT_DW_SKIP 0
#endif
constexpr int kSkip = OBJCAVIT_DW_SKIP;

// output columns a tap warp: k rolling rows of them, their inputs and the
// k^2 weight pairs take ~155 registers a lane, with no spill at 9 warps a
// block (13 warps capped the registers at 128, and k 5 spilled)
template <int K>
struct Cols {
  static constexpr int kCpw = K == 3 ? 10 : 5;
};

struct Job {
  int nb, h, w, c, slabs;
  int strip_w, band_w, seg_rows, strips, segments;
  int warps, stages, items, with_pool, direct_pool;
};

// kernels/mbconv.py::dw_smem_bytes: 128 bytes of alignment, the ring, the
// tap warps' pool sums, two mbarriers a stage
__host__ __device__ inline size_t smem_bytes(int band_w, int stages) {
  return 128 + (size_t)stages * band_w * kPixBytes + kMaxWarps * kSlab * 4 + 16 * kMaxStages;
}

__device__ __forceinline__ void bar_taps(int warps) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * warps) : "memory");
}

// work item i: its image, slab, (strip, segment) part, first output column
// and row, and output rows
struct Item {
  int b, slab, part, w0, h0, n_out;
};

__device__ __forceinline__ Item decode_item(int i, const Job& J) {
  Item it;
  const int parts = J.strips * J.segments;
  it.part = i % parts;
  const int bs = i / parts;  // (image, slab), slab fastest
  it.slab = bs % J.slabs;
  it.b = bs / J.slabs;
  it.w0 = (it.part / J.segments) * J.strip_w;
  it.h0 = (it.part % J.segments) * J.seg_rows;
  it.n_out = min(J.seg_rows, J.h - it.h0);
  return it;
}

template <int K>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1), 1)
    dw_silu_pool_kernel(const __grid_constant__ CUtensorMap tm_x, const bf16* __restrict__ wd,
                        const float* __restrict__ bd, bf16* __restrict__ y,
                        float* __restrict__ partial, float* __restrict__ pool, const Job J) {
  constexpr int kP = K / 2;
  constexpr int kCpw = Cols<K>::kCpw;
  constexpr int kNx = kCpw + 2 * kP;  // pixels of an input row a warp reads
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (128 - (raw & 127)) & 127;
  unsigned char* base = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const uint32_t slot_bytes = (uint32_t)J.band_w * kPixBytes;
  float* red = reinterpret_cast<float*>(base + (size_t)J.stages * slot_bytes);
  const uint32_t full = smem_addr(red + kMaxWarps * kSlab);
  const uint32_t empty = full + 8 * kMaxStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < J.stages; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's arrive with the bytes to come
      mbar_init(empty + 8 * s, J.warps);  // every tap warp, each after waiting for the row
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the same items and numbers their input rows in one
  // sequence g: ring slot g % stages, its fill g / stages (each role counts
  // the slot and the fill's parity as it goes). Every tap warp
  // waits for every row's fill before it hands the slot back, also a warp
  // with no columns in the item, so no arrival runs ahead of a fill and a
  // parity wait never faces a phase two fills away.
  if (warp == J.warps) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x))
                   : "memory");
      int slot = 0;
      uint32_t phase = 0;  // of the slot's next fill; its empty wait is for the one before
      bool refill = false;
      for (int i = blockIdx.x; i < J.items; i += gridDim.x) {
        const Item it = decode_item(i, J);
        const int rows = it.n_out + 2 * kP;
        for (int r = 0; r < rows; ++r) {
          if (refill) mbar_wait(empty + 8 * slot, phase ^ 1);  // the tap warps read the last fill
          if (kSkip == 2) {
            mbar_arrive(full + 8 * slot);
          } else {
            mbar_expect_tx(full + 8 * slot, slot_bytes);
            tma_load_4d(ring + slot * slot_bytes, &tm_x, full + 8 * slot, it.slab * kSlab,
                        it.w0 - kP, it.h0 - kP + r, it.b);
          }
          if (++slot == J.stages) {
            slot = 0;
            phase ^= 1;
            refill = true;
          }
        }
      }
    }
    return;
  }

  // the tap warps: lane = channel pair, warp = a run of kCpw output columns
  const int col0 = warp * kCpw;
  float2 wr[K * K], bias = make_float2(0.0f, 0.0f);
  int slot = 0, slab = -1;
  uint32_t phase = 0;  // of the slot's next fill
  for (int i = blockIdx.x; i < J.items; i += gridDim.x) {
    const Item it = decode_item(i, J);
    const int ch = it.slab * kSlab + 2 * lane;
    const bool live = ch < J.c;
    if (it.slab != slab) {
#pragma unroll
      for (int t = 0; t < K * K; ++t)
        wr[t] = live ? unpack(__ldg(reinterpret_cast<const uint32_t*>(wd + (long long)t * J.c + ch)))
                     : make_float2(0.0f, 0.0f);
      bias = live ? make_float2(__ldg(bd + ch), __ldg(bd + ch + 1)) : make_float2(0.0f, 0.0f);
      slab = it.slab;
    }
    const int ncols = min(kCpw, J.w - (it.w0 + col0));  // this warp's columns in the image
    const long long row_stride = (long long)J.w * J.c;
    bf16* yw = y + ((long long)it.b * J.h + it.h0) * row_stride + (long long)(it.w0 + col0) * J.c +
               ch;
    const int rows = it.n_out + 2 * kP;
    float2 acc[K][kCpw];  // output row o accumulates in acc[o % K]
    float2 psum = make_float2(0.0f, 0.0f);
    for (int r0 = 0; r0 < rows; r0 += K) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int r = r0 + q;  // input row h0 - p + r; r0 % K == 0, so r % K == q
        if (r >= rows) break;
        mbar_wait(full + 8 * slot, phase);
        if (kSkip != 1 && ncols > 0) {
          const uint32_t* src = reinterpret_cast<const uint32_t*>(
                                    base + (size_t)slot * slot_bytes + col0 * kPixBytes) +
                                lane;
          float2 xv[kNx];
#pragma unroll
          for (int n = 0; n < kNx; ++n) xv[n] = unpack(src[n * (kPixBytes / 4)]);
          // row r is tap row ti of output row o = r - ti; the columns'
          // chains interleave, each in tap order
#pragma unroll
          for (int ti = 0; ti < K; ++ti) {
            const int o = r - ti;
            if (o < 0 || o >= it.n_out) continue;
            float2(&a)[kCpw] = acc[(q - ti + K) % K];
            if (ti == 0) {
#pragma unroll
              for (int cc = 0; cc < kCpw; ++cc) a[cc] = make_float2(0.0f, 0.0f);
            }
#pragma unroll
            for (int j = 0; j < K; ++j)
#pragma unroll
              for (int cc = 0; cc < kCpw; ++cc) {
                a[cc].x = fmaf(xv[cc + j].x, wr[ti * K + j].x, a[cc].x);
                a[cc].y = fmaf(xv[cc + j].y, wr[ti * K + j].y, a[cc].y);
              }
            if (ti == K - 1) {  // output row o has all its taps
              bf16* yo = yw + o * row_stride;
#pragma unroll
              for (int cc = 0; cc < kCpw; ++cc) {
                if (cc >= ncols) break;
                const float v0 = silu(a[cc].x + bias.x), v1 = silu(a[cc].y + bias.y);
                if (live) *reinterpret_cast<__nv_bfloat162*>(yo) = __floats2bfloat162_rn(v0, v1);
                yo += J.c;
                psum.x += v0;
                psum.y += v1;
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * slot);
        if (++slot == J.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    if (J.with_pool) {
      // the item's pool: the tap warps' sums in warp order
      *reinterpret_cast<float2*>(red + warp * kSlab + 2 * lane) = psum;
      bar_taps(J.warps);
      if (warp == 0) {
        float2 sum = make_float2(0.0f, 0.0f);
        for (int k = 0; k < J.warps; ++k) {
          const float2 part = *reinterpret_cast<const float2*>(red + k * kSlab + 2 * lane);
          sum.x += part.x;
          sum.y += part.y;
        }
        float* dst = J.direct_pool ? pool + (long long)it.b * J.c
                                   : partial + ((long long)it.part * J.nb + it.b) * J.c;
        if (live) *reinterpret_cast<float2*>(dst + ch) = sum;
      }
      bar_taps(J.warps);
    }
  }
}

// x (B, H, W, C) as a 4-D tensor map (C, W, H, B), read in boxes of 64
// channels x band_w columns of one row of one image; no swizzle (a warp
// reads one pixel's 128-byte line at a time), zero outside the tensor
bool make_x_map(CUtensorMap* map, const void* x, int nb, int h, int w, int c, int band_w) {
  const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSlab, (cuuint32_t)band_w, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int K>
int launch(const CUtensorMap& tm, const void* wd, const void* bd, void* y, void* partial,
           void* pool, const Job& J, int grid, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_silu_pool_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dw_silu_pool_kernel<K><<<grid, 32 * (J.warps + 1), smem_bytes(J.band_w, J.stages), stream>>>(
      tm, (const bf16*)wd, (const float*)bd, (bf16*)y, (float*)partial, (float*)pool, J);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) bf16, contiguous; wd (k*k, C) bf16 and bd (C,) fp32; y
// like x; C % 8 == 0, pointers 16-byte aligned; k is 3 or 5. strip_w,
// seg_rows, warps, stages and grid are kernels/mbconv.py::dw_plan's:
// strip_w a multiple of the columns a warp takes (10 at k 3, 5 at k 5) and
// warps = strip_w / those columns, at most 8; at most 8 stages that fit
// in 227 KB beside the rest; grid at most the work items. With with_pool,
// pool (B, C) fp32 gets the spatial sum of the fp32 y and, unless one item
// covers an image's slab (one strip, one segment), partial is scratch of
// strips x segments x B x C fp32. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a plan the kernel does not take
// (an empty x has no items: the wrapper launches nothing for it) or a
// tensor map the driver refuses.
extern "C" int objcavit_dw_silu_pool(const void* x, const void* wd, const void* bd, void* y,
                                     void* partial, void* pool, int nb, int h, int w, int c,
                                     int ksize, int with_pool, int strip_w, int seg_rows,
                                     int warps, int stages, int grid, void* stream) {
  if (ksize != 3 && ksize != 5) return (int)cudaErrorInvalidValue;
  const int p = ksize / 2;
  const int cpw = ksize == 3 ? Cols<3>::kCpw : Cols<5>::kCpw;
  Job J;
  J.nb = nb, J.h = h, J.w = w, J.c = c, J.slabs = (c + kSlab - 1) / kSlab;
  J.strip_w = strip_w, J.band_w = strip_w + 2 * p, J.seg_rows = seg_rows;
  J.strips = strip_w > 0 ? (w + strip_w - 1) / strip_w : 0;
  J.segments = seg_rows > 0 ? (h + seg_rows - 1) / seg_rows : 0;
  J.warps = warps, J.stages = stages;
  J.items = nb * J.slabs * J.strips * J.segments;
  J.with_pool = with_pool;
  J.direct_pool = J.strips * J.segments == 1;
  if (c <= 0 || c % 8 || strip_w <= 0 || strip_w % cpw || warps != strip_w / cpw || warps < 1 ||
      warps > kMaxWarps || strip_w - cpw >= w || seg_rows <= 0 || seg_rows > h || stages < 2 ||
      stages > kMaxStages || smem_bytes(J.band_w, stages) > kSmemLimit || grid <= 0 ||
      grid > J.items || (with_pool && !J.direct_pool && !partial) || (with_pool && !pool))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!make_x_map(&tm, x, nb, h, w, c, J.band_w)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = ksize == 3 ? launch<3>(tm, wd, bd, y, partial, pool, J, grid, s)
                            : launch<5>(tm, wd, bd, y, partial, pool, J, grid, s);
  if (rc != 0 || !with_pool || J.direct_pool) return rc;
  const int bc = nb * c;
  pool_reduce_kernel<<<(bc + 255) / 256, 256, 0, s>>>((const float*)partial, (float*)pool,
                                                      J.strips * J.segments, bc);
  return (int)cudaGetLastError();
}
