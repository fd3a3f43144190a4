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
// before the skip is added, as in the TPU kernel.
//
// What bounds it on the H100: bytes. Per row it reads M and writes O <= M/4
// bf16 values and does 2 M O flops: about O flops per byte, under the
// card's ~295 bf16 flops per byte at every B5 block but stage 6's last
// (O = 512). The unfused route
// writes the gated (rows, M) tensor and reads it back for the project conv,
// then adds the bias and the skip in passes of their own; this kernel reads
// x once and writes only out.
//
// Design: a GEMM over rows with mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// A block owns 128 rows and 64 output columns, 8 warps of 32 x 32. M is
// walked in chunks of 32: each thread loads 16 bytes of x and of its row's
// image's gate (rows are indexed by image, so a tile that crosses images,
// as H*W = 300 at 15x20 does, gates each row by its own image), multiplies
// them in fp32 and stores the bf16 product to shared memory; the chunk of w
// comes in by cp.async. M and O past their ends are zero-filled (M = 24 or
// 48 is not a multiple of the chunk; O = 24 or 40 of the column tile). The
// epilogue adds the bias, rounds, adds the skip and stores two columns at a
// time. The weights (under 3.2 MB) stay in the 50 MB L2 across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;      // rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kKC = 32;       // M per chunk
constexpr int kLdA = kKC + 8; // 80-byte rows
constexpr int kLdB = kBN + 8; // 144-byte rows
constexpr int kThreads = 256; // 8 warps: 4 across rows x 2 across columns

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) se_project_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gate, const bf16* __restrict__ w,
    const float* __restrict__ bias, const bf16* __restrict__ skip, bf16* __restrict__ out,
    int rows, int hw, int m, int o) {
  __shared__ __align__(16) bf16 a_s[kBM * kLdA];
  __shared__ __align__(16) bf16 b_s[kKC * kLdB];

  const int row0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;  // 32 rows each
  const int warp_n = warp & 1;   // 32 columns each

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;

  for (int k0 = 0; k0 < m; k0 += kKC) {
    // w chunk (32 x 64) by cp.async, zero past M and O
    {
      const int kr = tid / (kBN / 8), s = tid % (kBN / 8);  // 256 = 32 x 8 segments
      const bool ok = k0 + kr < m && n0 + s * 8 < o;
      cp_async16(b_s + kr * kLdB + s * 8, ok ? w + (long long)(k0 + kr) * o + n0 + s * 8 : w, ok);
      cp_async_commit();
    }
    // gated x chunk (128 x 32) through registers: bf16(x * gate of the row's image)
#pragma unroll
    for (int it = 0; it < kBM * (kKC / 8) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kKC / 8), s = i % (kKC / 8);
      const int row = row0 + r, k = k0 + s * 8;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && k < m) {
        const uint4 xv = *reinterpret_cast<const uint4*>(x + (long long)row * m + k);
        const uint4 gv = *reinterpret_cast<const uint4*>(gate + (long long)(row / hw) * m + k);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
        __nv_bfloat162* pp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]);
          const float2 gf = __bfloat1622float2(gp[e]);
          pp[e] = __floats2bfloat162_rn(xf.x * gf.x, xf.y * gf.y);
        }
      }
      *reinterpret_cast<uint4*>(a_s + r * kLdA + s * 8) = packed;
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        const int j = lane >> 3;
        ldmatrix_x4_trans(r, b_s + (kk + (j & 1) * 8 + (lane & 7)) * kLdB + warp_n * 32 + np * 16 +
                                 (j >> 1) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, a_s + (warp_m * 32 + mt * 16 + (lane & 15)) * kLdA + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a, bfr[nt][0], bfr[nt][1]);
      }
    }
    __syncthreads();  // the tiles are refilled next chunk
  }

  // accumulator (mt, nt, j): row warp_m*32 + mt*16 + g + 8 (j / 2), column
  // warp_n*32 + nt*8 + 2 (lane % 4) + j % 2
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + warp_m * 32 + mt * 16 + g + 8 * hh;
      if (row >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + warp_n * 32 + nt * 8 + 2 * tq;  // O % 8 == 0: col < o implies col + 1 < o
        if (col >= o) continue;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][nt][2 * hh] + __ldg(bias + col),
                                                 acc[mt][nt][2 * hh + 1] + __ldg(bias + col + 1));
        const long long at = (long long)row * o + col;
        if (skip != nullptr) {
          const float2 vf = __bfloat1622float2(v);
          const float2 sf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(skip + at));
          v = __floats2bfloat162_rn(vf.x + sf.x, vf.y + sf.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + at) = v;
      }
    }
  }
}

}  // namespace

// x (rows, M) bf16 with rows = B * hw, gate (B, M) bf16, w (M, O) bf16, bias
// (O,) fp32, skip (rows, O) bf16 or null, out (rows, O) bf16; all contiguous
// and 16-byte aligned, M % 8 == 0, O % 8 == 0. Returns cudaGetLastError()
// after the launch.
extern "C" int objcavit_se_project(const void* x, const void* gate, const void* w,
                                   const void* bias, const void* skip, void* out, int rows, int hw,
                                   int m, int o, void* stream) {
  if (rows == 0 || o == 0) return (int)cudaSuccess;
  const dim3 grid((rows + kBM - 1) / kBM, (o + kBN - 1) / kBN);
  se_project_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)gate, (const bf16*)w, (const float*)bias, (const bf16*)skip,
      (bf16*)out, rows, hw, m, o);
  return (int)cudaGetLastError();
}
