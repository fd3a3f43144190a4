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
// (B, S, K) logits never reach device memory.
//
// What bounds it on the H100: operations. Each pixel reads 2*C bytes and does
// 2*C*K flops plus K exps, about 256 flops per byte read at C = 128; the
// flagship batch (B = 8, S = 76,800) is 40 GFLOP and 157 M exps against
// 157 MB of input. On the CUDA cores' fp32 FMAs that is ~0.6 ms at best, so
// the products run on the tensor cores.
//
// Design: a block stages its image's W transposed to (K, C) in shared memory
// (rows padded by 8 elements, so fragment loads hit 32 distinct banks), with
// the bias and centres. Each warp takes tiles of 16 pixels: it copies their x
// rows to its own shared tile, then computes the 16 x 256 logits with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) in two halves of 128 bins,
// keeping 64 accumulators per thread. The softmax is fp32 and online across
// the halves (running max, rescaled sums of e and e*c); the four lanes that
// share a pixel row combine with shuffles. The weight's batch stride is an
// argument, so a stride of 0 serves one shared W (the TPU's
// fused_conv_bins_depth).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kHalf = 128;           // bins per pass
constexpr int kTilesPerHalf = kHalf / 8;  // n-tiles of 8 bins per pass
constexpr int kRows = 16;            // pixels per warp tile (mma M)
constexpr int kWarps = 8;            // warps per block
constexpr int kPad = 8;              // bf16 elements of padding per smem row

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// max / sum over the 4 lanes (t = lane % 4) that hold one pixel row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kWarps * 32, 2) conv_bins_depth_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ centers,
    float* __restrict__ depth, int s_len, int c, long long w_bstride,
    int pix_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = c + kPad;  // row stride of the bf16 tiles
  float* bias_s = reinterpret_cast<float*>(smem);
  float* cent_s = bias_s + kBins;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(cent_s + kBins);  // (K, ld)
  __nv_bfloat16* x_s = w_s + (size_t)kBins * ld;                          // per warp (16, ld)

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group

  // stage W_b transposed: w_s[n][k] = W_b[k][n]; neighbouring threads take
  // neighbouring k, so their 2-byte stores share no bank
  const __nv_bfloat16* wb = w + (size_t)b * w_bstride;
  for (int i = threadIdx.x; i < c * kBins / 8; i += blockDim.x) {
    const int k = i % c;
    const int n0 = (i / c) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(wb + (size_t)k * kBins + n0));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) w_s[(size_t)(n0 + j) * ld + k] = e[j];
  }
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    bias_s[i] = bias[i];
    cent_s[i] = centers[(size_t)b * kBins + i];
  }
  __syncthreads();

  const int s_begin = blockIdx.x * pix_per_block;
  const int s_end = min(s_len, s_begin + pix_per_block);
  __nv_bfloat16* xw = x_s + (size_t)warp * kRows * ld;
  const __nv_bfloat16* xb = x + (size_t)b * s_len * c;
  const int vec_per_row = c / 8;

  for (int tile = s_begin + warp * kRows; tile < s_end; tile += kWarps * kRows) {
    for (int i = lane; i < kRows * vec_per_row; i += 32) {
      const int r = i / vec_per_row, v = i % vec_per_row;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (tile + r < s_end)
        val = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)(tile + r) * c) + v);
      *reinterpret_cast<uint4*>(xw + (size_t)r * ld + v * 8) = val;
    }
    __syncwarp();

    // running softmax state of rows g and g + 8, same in the row's 4 lanes
    float m_run[2] = {-INFINITY, -INFINITY};
    float s_run[2] = {0.0f, 0.0f};  // this lane's share of sum e
    float c_run[2] = {0.0f, 0.0f};  // this lane's share of sum e * centre

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[kTilesPerHalf][4];
#pragma unroll
      for (int nt = 0; nt < kTilesPerHalf; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

      for (int k0 = 0; k0 < c; k0 += 16) {
        const __nv_bfloat16* xa = xw + (size_t)g * ld + k0 + 2 * t;
        const uint32_t a0 = lds32(xa);
        const uint32_t a1 = lds32(xa + 8 * ld);
        const uint32_t a2 = lds32(xa + 8);
        const uint32_t a3 = lds32(xa + 8 * ld + 8);
#pragma unroll
        for (int nt = 0; nt < kTilesPerHalf; ++nt) {
          const __nv_bfloat16* wbk =
              w_s + (size_t)(half * kHalf + nt * 8 + g) * ld + k0 + 2 * t;
          mma_bf16_16816(acc[nt], a0, a1, a2, a3, lds32(wbk), lds32(wbk + 8));
        }
      }

      // accumulator (nt, j): row g + 8 * (j / 2), bin half*128 + nt*8 + 2t + j%2
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kTilesPerHalf; ++nt) {
          const int n = half * kHalf + nt * 8 + 2 * t;
          acc[nt][2 * r] += bias_s[n];
          acc[nt][2 * r + 1] += bias_s[n + 1];
          mx = fmaxf(mx, fmaxf(acc[nt][2 * r], acc[nt][2 * r + 1]));
        }
        const float m_new = fmaxf(m_run[r], quad_max(mx));
        const float scale = __expf(m_run[r] - m_new);  // 0 on the first half
        float se = 0.0f, sc = 0.0f;
#pragma unroll
        for (int nt = 0; nt < kTilesPerHalf; ++nt) {
          const int n = half * kHalf + nt * 8 + 2 * t;
          const float e0 = __expf(acc[nt][2 * r] - m_new);
          const float e1 = __expf(acc[nt][2 * r + 1] - m_new);
          se += e0 + e1;
          sc = fmaf(e0, cent_s[n], fmaf(e1, cent_s[n + 1], sc));
        }
        s_run[r] = s_run[r] * scale + se;
        c_run[r] = c_run[r] * scale + sc;
        m_run[r] = m_new;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float se = quad_sum(s_run[r]);
      const float sc = quad_sum(c_run[r]);
      const int row = tile + g + 8 * r;
      if (t == 0 && row < s_end) depth[(size_t)b * s_len + row] = sc / se;
    }
    __syncwarp();  // the next tile overwrites this warp's x tile
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for C input channels.
static size_t conv_bins_depth_smem(int c) {
  return 2 * kBins * sizeof(float) +
         ((size_t)kBins + (size_t)kWarps * kRows) * (c + kPad) * sizeof(__nv_bfloat16);
}

// x (B, S, C) bf16 contiguous, C % 16 == 0; w image b at w + b * w_bstride
// elements, each (C, 256) bf16 contiguous; bias (256,) and centers (B, 256)
// fp32; depth (B, S) fp32. x and w 16-byte aligned, w_bstride % 8 == 0.
// pix_per_block: pixels per block, a multiple of 16. Returns
// cudaGetLastError() after the launch.
extern "C" int objcavit_conv_bins_depth_batched(
    const void* x, const void* w, const void* bias, const void* centers,
    void* depth, int b, int s_len, int c, long long w_bstride,
    int pix_per_block, void* stream) {
  if (b == 0 || s_len == 0) return (int)cudaSuccess;
  const size_t smem = conv_bins_depth_smem(c);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bins_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_len + pix_per_block - 1) / pix_per_block, b);
  conv_bins_depth_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)centers, (float*)depth, s_len, c, w_bstride, pix_per_block);
  return (int)cudaGetLastError();
}
