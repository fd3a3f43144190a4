// Bilinear upsample with align_corners=True of an NHWC bf16 tensor.
//
// Replaces the TPU kernel objcavit_tpu/ops/resize_pallas.py::
// resize_bilinear_pallas (_kernel): the decoder's four skip upsamples
// (objcavit_tpu/models/decoder.py:91-98).
//
// What bounds it on the H100: bytes. Each output element costs four gathered
// reads (mostly L2 hits, since neighbouring outputs share their taps) and one
// write, with six flops between them; the flagship batch of 8 writes ~590 MB
// and reads ~150 MB across the four upsamples.
//
// Design: one thread per (output pixel, 8-channel group). It reads the four
// tap pixels as 16-byte vectors, lerps in fp32 (H first, then W, the order of
// the plain version in objcavit_torch/ops/resize.py), rounds to bf16 once and
// stores 16 bytes. Neighbouring threads cover neighbouring channel groups, so
// every load and store is coalesced. Row and column taps (lo, hi, frac) come
// from small tables computed on the host in float64: computing
// o*(in-1)/(out-1) in float32 here could put floor() on the wrong side of an
// integer. The TPU kernel's dense (Wo, Wi) matrix product, its W padding and
// its bf16 rounding between the H and W passes existed for the TPU's layout
// and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__global__ void resize_bilinear_ac_nhwc_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
    const int* __restrict__ h_lo, const int* __restrict__ h_hi,
    const float* __restrict__ h_frac, const int* __restrict__ w_lo,
    const int* __restrict__ w_hi, const float* __restrict__ w_frac, int hi,
    int wi, int c, int ho, int wo, long long n_vec) {
  const int cv = c / 8;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += step) {
    const int v = (int)(i % cv);
    long long p = i / cv;
    const int ox = (int)(p % wo);
    p /= wo;
    const int oy = (int)(p % ho);
    const long long b = p / ho;

    const int y0 = h_lo[oy], y1 = h_hi[oy];
    const int x0 = w_lo[ox], x1 = w_hi[ox];
    const float fy = h_frac[oy], fx = w_frac[ox];

    const __nv_bfloat16* img = x + (size_t)b * hi * wi * c + (size_t)v * 8;
    float a[8], bb[8], cc[8], d[8];
    load8(img + ((size_t)y0 * wi + x0) * c, a);
    load8(img + ((size_t)y0 * wi + x1) * c, bb);
    load8(img + ((size_t)y1 * wi + x0) * c, cc);
    load8(img + ((size_t)y1 * wi + x1) * c, d);

    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float r[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int k = 2 * j + t;
        const float left = a[k] * (1.0f - fy) + cc[k] * fy;
        const float right = bb[k] * (1.0f - fy) + d[k] * fy;
        r[t] = left * (1.0f - fx) + right * fx;
      }
      o[j] = __floats2bfloat162_rn(r[0], r[1]);
    }
    *reinterpret_cast<uint4*>(y + (size_t)i * 8) = out;
  }
}

}  // namespace

// x (B, Hi, Wi, C) and y (B, Ho, Wo, C), contiguous bf16, C % 8 == 0, both
// 16-byte aligned; taps are int32 / float32 device tables of length Ho and Wo.
// Returns cudaGetLastError() after the launch.
extern "C" int objcavit_resize_bilinear_ac_nhwc_bf16(
    const void* x, void* y, const void* h_lo, const void* h_hi,
    const void* h_frac, const void* w_lo, const void* w_hi, const void* w_frac,
    int b, int hi, int wi, int c, int ho, int wo, void* stream) {
  const long long n_vec = (long long)b * ho * wo * (c / 8);
  if (n_vec == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long want = (n_vec + threads - 1) / threads;
  const int blocks = (int)(want < (1LL << 30) ? want : (1LL << 30));
  resize_bilinear_ac_nhwc_bf16_kernel<<<blocks, threads, 0,
                                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (const int*)h_lo,
      (const int*)h_hi, (const float*)h_frac, (const int*)w_lo,
      (const int*)w_hi, (const float*)w_frac, hi, wi, c, ho, wo, n_vec);
  return (int)cudaGetLastError();
}
