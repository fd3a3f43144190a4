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
// batch 8 the three levels are 128 GFLOP against ~34 MB of features read and
// a few MB written (~4000 flops per byte), far above the card's ~295 bf16
// flops per byte of HBM. On the CUDA cores' fp32 FMAs that would be ~2 ms,
// so the products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate). wgmma, TMA and warp specialisation are left for a later PR.
//
// Design: a block owns BM = 32 * WARPS_M positions and one column group:
// groups 0-2 are the nc class columns of anchor a (repacked once, when the
// weights are loaded, to (3, ncp, Cin): column-major B, rows past nc zero,
// ncp a multiple of 128); group 3 is the 15 box/objectness and 3*nm
// coefficient columns packed into one 128-column tile ([a0 box 5 | a1 | a2 |
// a0 coef nm | a1 | a2 | zero pad], the TPU kernel's packing). The block
// walks its group's 128-column tiles; for each it walks Cin in chunks of 64
// staged through shared memory by a 3-stage cp.async ring (Cin up to 1024
// never has to fit at once), and each warp keeps a 32 x 64 tile of fp32
// accumulators. After a class tile, each thread folds its 64 logits into a
// running max and index per row (strict >, columns in increasing order, so
// the first maximum stays); columns past nc are skipped by index. At the
// end the four lanes of a row and then the two warps of a row merge with
// shuffles and shared memory, ties going to the smaller index (jnp.argmax's
// rule), and the result is stored straight into (B, S, 3). The weights of a
// level (2.0-7.9 MB) stay in the 50 MB L2 across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNa = 3;        // anchors per position
constexpr int kBN = 128;      // columns per tile
constexpr int kBK = 64;       // input channels per shared-memory chunk
constexpr int kPad = 8;       // bf16 padding per row: 144-byte rows, no bank conflicts
constexpr int kLd = kBK + kPad;
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kWarpsN = 2;    // warps across a 128-column tile, 64 columns each
constexpr int kBox = 5 * kNa; // packed box/objectness columns of group 3

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// (v, i) beats (best, arg): larger value, or the same value at a smaller index
__device__ __forceinline__ bool beats(float v, int i, float best, int arg) {
  return v > best || (v == best && i < arg);
}

template <int WARPS_M>
struct Tile {
  static constexpr int kBM = 32 * WARPS_M;
  static constexpr int kThreads = 32 * WARPS_M * kWarpsN;
  static constexpr int kStageElems = (kBM + kBN) * kLd;  // A rows, then B rows
  static constexpr size_t kSmem =
      (size_t)kStages * kStageElems * sizeof(__nv_bfloat16) + (size_t)kWarpsN * kBM * 8;
};

template <int WARPS_M>
__global__ void __launch_bounds__(Tile<WARPS_M>::kThreads) detect_head_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wcls,
    const float* __restrict__ bcls, const __nv_bfloat16* __restrict__ w5c,
    const float* __restrict__ b5c, __nv_bfloat16* __restrict__ y5,
    __nv_bfloat16* __restrict__ coef, float* __restrict__ cls_max, int* __restrict__ cls_arg,
    int m, int cin, int nc, int ncp, int nm) {
  constexpr int kBM = Tile<WARPS_M>::kBM;
  constexpr int kThreads = Tile<WARPS_M>::kThreads;
  constexpr int kStageElems = Tile<WARPS_M>::kStageElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red_v = reinterpret_cast<float*>(smem + kStages * kStageElems);  // (kWarpsN, kBM)
  int* red_i = reinterpret_cast<int*>(red_v + kWarpsN * kBM);

  const int group = blockIdx.y;  // 0..2: anchor's classes; 3: box/obj + coefficients
  const bool is_cls = group < kNa;
  const int row0 = blockIdx.x * kBM;
  const __nv_bfloat16* w = is_cls ? wcls + (size_t)group * ncp * cin : w5c;
  const float* bias = is_cls ? bcls + (size_t)group * ncp : b5c;
  const int k_chunks = cin / kBK;
  const int steps = (is_cls ? ncp / kBN : 1) * k_chunks;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp % kWarpsN;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group

  // step s: column tile s / k_chunks, channel chunk s % k_chunks
  auto load = [&](int step, int stage) {
    const int k0 = (step % k_chunks) * kBK;
    const int n0 = (step / k_chunks) * kBN;
    __nv_bfloat16* a_s = smem + stage * kStageElems;
    __nv_bfloat16* b_s = a_s + kBM * kLd;
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const bool ok = row0 + r < m;
      cp_async16(a_s + r * kLd + c * 8, x + (size_t)(ok ? row0 + r : 0) * cin + k0 + c * 8, ok);
    }
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      cp_async16(b_s + r * kLd + c * 8, w + (size_t)(n0 + r) * cin + k0 + c * 8, true);
    }
  };

  float acc[2][8][4];
  float best[2][2];
  int arg[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mt][h] = -INFINITY;
      arg[mt][h] = 0x7fffffff;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk `step` landed; the stage read at step - 1 is free
    if (step + kStages - 1 < steps) load(step + kStages - 1, (step + kStages - 1) % kStages);
    cp_async_commit();

    const __nv_bfloat16* a_s = smem + (step % kStages) * kStageElems;
    const __nv_bfloat16* b_s = a_s + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], a_s + (warp_m * 32 + mt * 16 + (lane & 15)) * kLd + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // four 8x8 matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        uint32_t b[4];
        const int n = warp_n * 64 + np * 16 + ((lane >> 4) << 3) + (lane & 7);
        ldmatrix_x4(b, b_s + n * kLd + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    if (step % k_chunks != k_chunks - 1) continue;
    // epilogue of a column tile; accumulator (mt, nt, j) holds row
    // warp_m*32 + mt*16 + g + 8*(j/2), column warp_n*64 + nt*8 + 2t + j%2
    const int n0 = (step / k_chunks) * kBN + warp_n * 64 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + warp_m * 32 + mt * 16 + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n0 + nt * 8 + j;
            const __nv_bfloat16 v = __float2bfloat16(acc[mt][nt][2 * h + j] + __ldg(bias + col));
            if (is_cls) {
              const float vf = __bfloat162float(v);
              if (col < nc && vf > best[mt][h]) {
                best[mt][h] = vf;
                arg[mt][h] = col;
              }
            } else if (row < m) {
              if (col < kBox)
                y5[(size_t)row * kBox + col] = v;
              else if (col < kBox + kNa * nm)
                coef[(size_t)row * kNa * nm + (col - kBox)] = v;
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
    }
  }
  if (!is_cls) return;

  // merge the four lanes of a row, then the two warps of a row
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[mt][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, arg[mt][h], off);
        if (beats(ov, oi, best[mt][h], arg[mt][h])) {
          best[mt][h] = ov;
          arg[mt][h] = oi;
        }
      }
      if (t == 0) {
        const int r = warp_m * 32 + mt * 16 + g + 8 * h;
        red_v[warp_n * kBM + r] = best[mt][h];
        red_i[warp_n * kBM + r] = arg[mt][h];
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < kBM; r += kThreads) {
    float v = red_v[r];
    int i = red_i[r];
#pragma unroll
    for (int wn = 1; wn < kWarpsN; ++wn) {
      if (beats(red_v[wn * kBM + r], red_i[wn * kBM + r], v, i)) {
        v = red_v[wn * kBM + r];
        i = red_i[wn * kBM + r];
      }
    }
    if (row0 + r < m) {
      cls_max[(size_t)(row0 + r) * kNa + group] = v;
      cls_arg[(size_t)(row0 + r) * kNa + group] = i;
    }
  }
}

template <int WARPS_M>
int launch(const void* x, const void* wcls, const void* bcls, const void* w5c, const void* b5c,
           void* y5, void* coef, void* cls_max, void* cls_arg, int m, int cin, int nc, int ncp,
           int nm, cudaStream_t stream) {
  const size_t smem = Tile<WARPS_M>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      detect_head_kernel<WARPS_M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + Tile<WARPS_M>::kBM - 1) / Tile<WARPS_M>::kBM, kNa + 1);
  detect_head_kernel<WARPS_M><<<grid, Tile<WARPS_M>::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wcls, (const float*)bcls,
      (const __nv_bfloat16*)w5c, (const float*)b5c, (__nv_bfloat16*)y5, (__nv_bfloat16*)coef,
      (float*)cls_max, (int*)cls_arg, m, cin, nc, ncp, nm);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, Cin) bf16; wcls (3, ncp, Cin) bf16 and bcls (3, ncp) fp32, the class
// columns of each anchor; w5c (128, Cin) bf16 and b5c (128,) fp32, the packed
// box/objectness and coefficient columns; outputs y5 (M, 3, 5) and coef
// (M, 3, nm) bf16, cls_max (M, 3) fp32, cls_arg (M, 3) int32. All contiguous
// and 16-byte aligned; Cin % 64 == 0, ncp % 128 == 0, nc <= ncp, 15 + 3 nm
// <= 128. block_rows is 128 or 64 positions per block. Returns
// cudaGetLastError() after the launch.
extern "C" int objcavit_detect_head(const void* x, const void* wcls, const void* bcls,
                                    const void* w5c, const void* b5c, void* y5, void* coef,
                                    void* cls_max, void* cls_arg, int m, int cin, int nc, int ncp,
                                    int nm, int block_rows, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (block_rows == 128)
    return launch<4>(x, wcls, bcls, w5c, b5c, y5, coef, cls_max, cls_arg, m, cin, nc, ncp, nm, s);
  if (block_rows == 64)
    return launch<2>(x, wcls, bcls, w5c, b5c, y5, coef, cls_max, cls_arg, m, cin, nc, ncp, nm, s);
  return (int)cudaErrorInvalidValue;
}
