// Softmax over bins and expectation over bin centres, forward and backward.
//
// Replaces the TPU kernels objcavit_tpu/ops/pallas_bins.py::_fwd_impl
// (_fwd_kernel) and ::_bwd (_bwd_kernel): the custom VJP of
// fused_bins_depth, which the training route of the bins head runs on
// materialised logits (objcavit_tpu/ops/bins.py:79-89):
//
//   depth[r]       = sum_k p[r,k] c[k],   p[r,:] = softmax(logits[r,:])
//   dlogits[r,k]   = p[r,k] (c[k] - depth[r]) g[r]
//   dcenters[b,k]  = sum over the rows r of image b of p[r,k] g[r]
//
// logits (B, S, 256) bf16, centers (B, 256) fp32, depth and g (B, S) fp32,
// dlogits (B, S, 256) bf16.
//
// What bounds it on the H100: bytes. A row is 512 bytes of logits against
// 256 exps and ~1k flops. The train batch (8, 56,576, 256) is 232 MB of
// logits: the forward reads it once (~70 us at 3.35 TB/s), the backward
// reads it and writes dlogits (464 MB, ~140 us). Their 116 M exps a pass
// take ~30 us on the special-function units, under the memory time.
//
// Design: one warp per row. Each lane loads 16 bytes (8 consecutive bins),
// so a warp reads a row in one coalesced 512-byte access; the max and the
// sums of e and e*c are fp32 warp shuffles. A block's rows all lie in one
// image, so each lane keeps its 8 centres in registers for the whole block.
// A warp issues the loads of kUnroll rows before it reduces any, so enough
// bytes are in flight to cover the memory latency. The backward recomputes
// p from the logits, as the TPU kernel does, instead of saving fp32
// probabilities. Each lane sums p*g of its 8 bins over the warp's rows in
// registers; the block adds its warps' sums in shared memory and writes
// one (256,) partial. The TPU kernel carried nothing across its grid either
// (pallas_bins.py:123 sums per-tile partials); the wrapper sums an image's
// partials with torch.sum. No atomics: results do not depend on timing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kPerLane = 8;  // bins per lane: one 16-byte vector
constexpr int kWarps = 8;    // warps per block
constexpr int kUnroll = 4;   // rows a warp loads before reducing

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float v[kPerLane]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// e[i] = exp(v[i] - max over the row); returns (sum e, sum e*c) of the row
__device__ __forceinline__ float2 softmax_sums(float v[kPerLane], const float c[kPerLane]) {
  float m = v[0];
#pragma unroll
  for (int i = 1; i < kPerLane; ++i) m = fmaxf(m, v[i]);
  m = warp_max(m);
  float se = 0.f, sc = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    v[i] = __expf(v[i] - m);
    se += v[i];
    sc += v[i] * c[i];
  }
  return make_float2(warp_sum(se), warp_sum(sc));
}

__device__ __forceinline__ void load_centers(const float* centers, int lane, float c[kPerLane]) {
  const float4 lo = *reinterpret_cast<const float4*>(centers + lane * kPerLane);
  const float4 hi = *reinterpret_cast<const float4*>(centers + lane * kPerLane + 4);
  c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
  c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
}

// grid (blocks per image, B); a block takes rows [x * rows_per_block, +rows_per_block)
__global__ void __launch_bounds__(kWarps * 32)
bins_expectation_fwd_kernel(const __nv_bfloat16* __restrict__ logits,
                            const float* __restrict__ centers, float* __restrict__ depth,
                            int s_len, int rows_per_block) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(row0 + rows_per_block, s_len);
  float c[kPerLane];
  load_centers(centers + (size_t)b * kBins, lane, c);
  const __nv_bfloat16* rows = logits + (size_t)b * s_len * kBins + lane * kPerLane;
  float* out = depth + (size_t)b * s_len;

  // the loop bound and every row index are warp-uniform, so each shuffle
  // runs with all 32 lanes
  for (int r = row0 + warp; r < row_end; r += kWarps * kUnroll) {
    float v[kUnroll][kPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kWarps;
      if (row < row_end) {
        load_row(rows + (size_t)row * kBins, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kWarps;
      const float2 s = softmax_sums(v[u], c);
      if (lane == 0 && row < row_end) out[row] = s.y / s.x;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
bins_expectation_bwd_kernel(const __nv_bfloat16* __restrict__ logits,
                            const float* __restrict__ centers, const float* __restrict__ g,
                            __nv_bfloat16* __restrict__ dlogits,
                            float* __restrict__ dcenters_part, int s_len, int rows_per_block) {
  __shared__ float part[kWarps][kBins];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(row0 + rows_per_block, s_len);
  float c[kPerLane];
  load_centers(centers + (size_t)b * kBins, lane, c);
  const size_t image = (size_t)b * s_len;
  const __nv_bfloat16* rows = logits + image * kBins + lane * kPerLane;
  __nv_bfloat16* drows = dlogits + image * kBins + lane * kPerLane;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  for (int r = row0 + warp; r < row_end; r += kWarps * kUnroll) {
    float v[kUnroll][kPerLane];
    float gr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kWarps;
      if (row < row_end) {
        load_row(rows + (size_t)row * kBins, v[u]);
        gr[u] = __ldg(g + image + row);
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) v[u][i] = 0.f;
        gr[u] = 0.f;  // a zero g adds nothing to acc
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kWarps;
      const float2 s = softmax_sums(v[u], c);
      const float inv = 1.f / s.x;
      const float d = s.y * inv;
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < kPerLane; i += 2) {
        const float p0 = v[u][i] * inv, p1 = v[u][i + 1] * inv;
        acc[i] += p0 * gr[u];
        acc[i + 1] += p1 * gr[u];
        h[i / 2] = __floats2bfloat162_rn(p0 * (c[i] - d) * gr[u], p1 * (c[i + 1] - d) * gr[u]);
      }
      if (row < row_end) *reinterpret_cast<uint4*>(drows + (size_t)row * kBins) = packed;
    }
  }

#pragma unroll
  for (int i = 0; i < kPerLane; ++i) part[warp][lane * kPerLane + i] = acc[i];
  __syncthreads();
  // kWarps * 32 threads == kBins: thread t sums bin t over the warps
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
  dcenters_part[((size_t)b * gridDim.x + blockIdx.x) * kBins + threadIdx.x] = sum;
}

static_assert(kWarps * 32 == kBins, "the partial reduction gives one thread per bin");

}  // namespace

// logits (B, S, 256) bf16 contiguous and 16-byte aligned; centers (B, 256)
// fp32 contiguous and 16-byte aligned; depth (B, S) fp32. rows_per_block > 0.
// Returns cudaGetLastError() after the launch.
extern "C" int objcavit_bins_expectation_fwd(const void* logits, const void* centers,
                                              void* depth, int b, int s_len,
                                              int rows_per_block, void* stream) {
  if (b == 0 || s_len == 0) return (int)cudaSuccess;
  const dim3 grid((s_len + rows_per_block - 1) / rows_per_block, b);
  bins_expectation_fwd_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)logits, (const float*)centers, (float*)depth, s_len,
      rows_per_block);
  return (int)cudaGetLastError();
}

// As the forward, plus g (B, S) fp32 contiguous, dlogits (B, S, 256) bf16
// contiguous and 16-byte aligned, and dcenters_part (B, nblk, 256) fp32 with
// nblk = ceil(S / rows_per_block): one partial sum per block, every entry
// written.
extern "C" int objcavit_bins_expectation_bwd(const void* logits, const void* centers,
                                              const void* g, void* dlogits,
                                              void* dcenters_part, int b, int s_len,
                                              int rows_per_block, void* stream) {
  if (b == 0 || s_len == 0) return (int)cudaSuccess;
  const dim3 grid((s_len + rows_per_block - 1) / rows_per_block, b);
  bins_expectation_bwd_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)logits, (const float*)centers, (const float*)g,
      (__nv_bfloat16*)dlogits, (float*)dcenters_part, s_len, rows_per_block);
  return (int)cudaGetLastError();
}
