// Fused MBConv head: 1x1 expand -> SiLU -> kxk depthwise -> SiLU -> SE pool.
//
// Replaces three TPU kernels with one CUDA kernel:
//   * objcavit_tpu/ops/mbconv_pallas.py::mbconv_expand_dw_pool (_kernel), the
//     EfficientNet MBConv body of fused_mbconv_head=True, on NHWC tensors;
//   * objcavit_tpu/ops/mbconv_bs.py::mbconv_bs_expand_dw_pool (_kernel), the
//     same on (H, W, B, C) tensors: here only the strides differ;
//   * objcavit_tpu/ops/dw_pallas.py::dw_conv_silu_pool (_dw_kernel), the
//     depthwise conv, bias, SiLU and optional pool sum without the expand
//     (expand = 0).
//
//   e    = silu(x @ we + be), zeroed outside the image, rounded to bf16
//          (expand = 0: e = x)
//   y    = silu(sum_ij e[h+i-p, w+j-p] * wd[i, j] + bd)     SAME, stride 1
//   pool = sum_hw y, from the fp32 y before its bf16 rounding
//
// x (Cin channels) and y (M channels) are bf16 with the channel dimension
// contiguous and the batch, row and column strides given in elements; we is
// (Cin, M) bf16, wd (k*k, M) bf16, be and bd (M,) fp32, pool (B, M) fp32.
//
// What bounds it on the H100: bytes. At EfficientNet-B5's stride-1 blocks
// (480x640, batch 8) a block reads Cin and writes M = 6 Cin channels a pixel
// and does 2 Cin M + 2 k^2 M flops on it: ~2 flops per byte for the
// depthwise on the CUDA cores and ~Cin/4 per byte for the expand on the
// tensor cores, both under the card's balance point. The unfused route
// writes and reads the expanded tensor about 15 times (conv output, bias,
// SiLU, depthwise, bias, SiLU, SE mean, gate, project); this kernel writes
// it once, and its SE consumer reads it once more.
//
// Design: a block owns one image, an 8 x 16 tile of output pixels and 48 of
// the M channels (48 divides every B5 M; a ragged last tile is masked). It
// expands the haloed input band ((8 + 2p) x (16 + 2p) pixels, p = k / 2)
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate), Cin streamed through
// shared memory in chunks of 32 by a two-stage cp.async ring and zero-filled
// past Cin (Cin 24 or 40 is not a multiple of the mma depth), so a large Cin
// never has to fit at once. The epilogue adds be, applies SiLU, zeroes every
// band pixel outside the image (the zero padding would otherwise expand to
// silu(be) != 0) and keeps the band in shared memory as bf16, the TPU
// kernel's rounding point. The depthwise then splits the tile into 768
// jobs of two channels and a column strip of 4 output rows, three a
// thread: a job reads each of its (4 + 2p) x k band values once, as bf16
// pairs, and adds it into every output it touches (4 x 2 fp32 sums in
// registers, each in the TPU kernel's tap order), then adds bd, applies
// SiLU, writes bf16 pairs of y and sums the fp32 y. The pool has
// no carried sum (blocks run in any order): each block writes its tile's
// partial sums, and a second kernel adds a channel's partials over the tiles
// in order, with no atomics, so the pool is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 8;        // output tile rows
constexpr int kTW = 16;       // output tile columns
constexpr int kMT = 48;       // channels per block
constexpr int kKC = 32;       // input channels per expand chunk
constexpr int kLdA = kKC + 8; // 80-byte band rows: ldmatrix rows hit distinct banks
constexpr int kLdE = kMT + 8; // 112-byte rows, the same for the weight chunk and the band
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 4;                          // depthwise job: 4 output rows of a column
constexpr int kStrips = (kTH / kStrip) * kTW;      // 32 column strips a tile
constexpr int kPairs = kMT / 2;                    // 24 channel pairs
constexpr int kJobs = kStrips * kPairs;            // 768 = 3 a thread
static_assert(kJobs % kThreads == 0, "the depthwise jobs split evenly over the threads");

template <int K>
struct Geo {
  static constexpr int kP = K / 2;
  static constexpr int kBW = kTW + 2 * kP;  // band columns
  static constexpr int kR = (kTH + 2 * kP) * kBW;  // band pixels
  static constexpr int kRp = (kR + 15) / 16 * 16;   // padded to mma rows
  static constexpr int kMTiles = kRp / 16;
  static constexpr int kStage = kRp * kLdA + kKC * kLdE;  // bf16 elements of one ring stage
  static constexpr int kBand = kRp * kLdE;
  // the pool partials reuse the expand's ring, dead by then
  static constexpr size_t kSmemExpand = (2 * (size_t)kStage + kBand) * 2;
  static constexpr size_t kSmemDw = (size_t)kBand * 2 + kStrips * kMT * 4;
};

static_assert(Geo<5>::kMTiles <= 2 * kWarps, "each warp takes at most two row tiles");
static_assert(2 * Geo<3>::kStage * 2 >= kStrips * kMT * 4, "the ring holds the pool partials");
constexpr int kMinBlocks = 3;  // blocks an SM keeps in flight: <= 85 registers a thread

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

// four 8x8 bf16 matrices, transposed: the B fragments of a row-major [k][n] tile
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

// v * sigmoid(v); the reciprocal of inf is 0, so a very negative v gives -0
__device__ __forceinline__ float silu(float v) { return v * __frcp_rn(1.0f + __expf(-v)); }

template <int K, bool EXPAND>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mbconv_head_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ we, const float* __restrict__ be,
    const bf16* __restrict__ wd, const float* __restrict__ bd, bf16* __restrict__ y,
    float* __restrict__ partial, int nb, int h_img, int w_img, int cin, int m, long long xsb,
    long long xsh, long long xsw, long long ysb, long long ysh, long long ysw, int tiles_w,
    int with_pool) {
  using G = Geo<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* band = EXPAND ? smem + 2 * G::kStage : smem;  // (kRp, kLdE) bf16
  // (kStrips, kMT) pool partials: in the ring after the expand
  float* red = reinterpret_cast<float*>(EXPAND ? smem : band + G::kBand);

  const int tile = blockIdx.x;
  const int m0 = blockIdx.y * kMT;
  const int b = blockIdx.z;
  const int h0 = (tile / tiles_w) * kTH;
  const int w0 = (tile % tiles_w) * kTW;
  const int tid = threadIdx.x;
  const bf16* xb = x + b * xsb;

  // band pixel q -> its offset in x's image; false outside the image
  auto band_src = [&](int q, long long& off) -> bool {
    if (q >= G::kR) return false;
    const int h = h0 - G::kP + q / G::kBW;
    const int w = w0 - G::kP + q % G::kBW;
    if (h < 0 || h >= h_img || w < 0 || w >= w_img) return false;
    off = h * xsh + w * xsw;
    return true;
  };

  if (EXPAND) {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int chunks = (cin + kKC - 1) / kKC;
    auto load = [&](int chunk, int stage) {
      bf16* a_s = smem + stage * G::kStage;
      bf16* b_s = a_s + G::kRp * kLdA;
      const int k0 = chunk * kKC;
      for (int i = tid; i < G::kRp * (kKC / 8); i += kThreads) {
        const int q = i / (kKC / 8), s = i % (kKC / 8);
        long long off = 0;
        const bool ok = band_src(q, off) && k0 + s * 8 < cin;
        cp_async16(a_s + q * kLdA + s * 8, ok ? xb + off + k0 + s * 8 : x, ok);
      }
      for (int i = tid; i < kKC * (kMT / 8); i += kThreads) {
        const int kr = i / (kMT / 8), s = i % (kMT / 8);
        const bool ok = k0 + kr < cin && m0 + s * 8 < m;
        cp_async16(b_s + kr * kLdE + s * 8, ok ? we + (long long)(k0 + kr) * m + m0 + s * 8 : we,
                   ok);
      }
    };

    float acc[2][kMT / 8][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < kMT / 8; ++nt) acc[t][nt][0] = acc[t][nt][1] = acc[t][nt][2] = acc[t][nt][3] = 0.0f;

    load(0, 0);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) load(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // chunk c landed
      const bf16* a_s = smem + (c & 1) * G::kStage;
      const bf16* b_s = a_s + G::kRp * kLdA;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        uint32_t bfr[kMT / 8][2];
#pragma unroll
        for (int np = 0; np < kMT / 16; ++np) {
          uint32_t r[4];
          const int j = lane >> 3;
          ldmatrix_x4_trans(r, b_s + (kk + (j & 1) * 8 + (lane & 7)) * kLdE + np * 16 + (j >> 1) * 8);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int mt = warp + kWarps * t;
          if (mt >= G::kMTiles) continue;
          uint32_t a[4];
          ldmatrix_x4(a, a_s + (mt * 16 + (lane & 15)) * kLdA + kk + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < kMT / 8; ++nt) mma_bf16_16816(acc[t][nt], a, bfr[nt][0], bfr[nt][1]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // accumulator (t, nt, j): band pixel (warp + 8 t) * 16 + g + 8 (j / 2),
    // channel nt * 8 + 2 (lane % 4) + j % 2
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int mt = warp + kWarps * t;
      if (mt >= G::kMTiles) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = mt * 16 + g + 8 * hh;
        long long off = 0;
        const bool inside = band_src(q, off);
#pragma unroll
        for (int nt = 0; nt < kMT / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          const int ch = m0 + col;  // M % 8 == 0: ch < m implies ch + 1 < m
          float v0 = 0.0f, v1 = 0.0f;
          if (inside && ch < m) {
            v0 = silu(acc[t][nt][2 * hh] + __ldg(be + ch));
            v1 = silu(acc[t][nt][2 * hh + 1] + __ldg(be + ch + 1));
          }
          *reinterpret_cast<__nv_bfloat162*>(band + q * kLdE + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();
  } else {
    // no expand: the band is x's own channels m0..m0+47, zero outside the image
    for (int i = tid; i < G::kRp * (kMT / 8); i += kThreads) {
      const int q = i / (kMT / 8), s = i % (kMT / 8);
      long long off = 0;
      const bool ok = band_src(q, off) && m0 + s * 8 < m;
      cp_async16(band + q * kLdE + s * 8, ok ? xb + off + m0 + s * 8 : x, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // depthwise: job j takes channels m0 + 2 (j % 24) + {0, 1} and the strip
  // j / 24 (column strip % 16, rows 4 (strip / 16) .. + 3)
  bf16* yb = y + b * ysb;
#pragma unroll 1
  for (int job = tid; job < kJobs; job += kThreads) {
    const int pair = job % kPairs, strip = job / kPairs;
    const int c = strip % kTW, r0 = (strip / kTW) * kStrip;
    const int mc = m0 + 2 * pair;
    float2 psum = make_float2(0.0f, 0.0f);
    if (mc < m) {  // M % 8 == 0: mc + 1 < m too
      float2 wr[K * K];
#pragma unroll
      for (int i = 0; i < K * K; ++i)
        wr[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wd + (long long)i * m + mc));
      float2 acc[kStrip];
#pragma unroll
      for (int o = 0; o < kStrip; ++o) acc[o] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int rr = 0; rr < kStrip + 2 * G::kP; ++rr) {
        float2 v[K];
#pragma unroll
        for (int j = 0; j < K; ++j)
          v[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              band + ((r0 + rr) * G::kBW + c + j) * kLdE + 2 * pair));
        // band row r0 + rr is tap row i = rr - o of output row r0 + o; rows
        // reach each output in increasing i, so each sum keeps the tap order
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
          const int i = rr - o;
          if (i < 0 || i >= K) continue;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            acc[o].x += v[j].x * wr[i * K + j].x;
            acc[o].y += v[j].y * wr[i * K + j].y;
          }
        }
      }
      const float2 bias = make_float2(__ldg(bd + mc), __ldg(bd + mc + 1));
      const int w = w0 + c;
#pragma unroll
      for (int o = 0; o < kStrip; ++o) {
        const int h = h0 + r0 + o;
        if (h >= h_img || w >= w_img) continue;
        const float v0 = silu(acc[o].x + bias.x), v1 = silu(acc[o].y + bias.y);
        *reinterpret_cast<__nv_bfloat162*>(yb + h * ysh + w * ysw + mc) =
            __floats2bfloat162_rn(v0, v1);
        psum.x += v0;
        psum.y += v1;
      }
    }
    if (with_pool) *reinterpret_cast<float2*>(red + strip * kMT + 2 * pair) = psum;
  }
  if (with_pool) {
    __syncthreads();
    if (tid < kMT && m0 + tid < m) {
      float s = 0.0f;
      for (int st = 0; st < kStrips; ++st) s += red[st * kMT + tid];
      partial[((long long)tile * nb + b) * m + m0 + tid] = s;
    }
  }
}

// pool[i] = sum over tiles t, in order, of partial[t][i]; i < B * M
__global__ void pool_reduce_kernel(const float* __restrict__ partial, float* __restrict__ pool,
                                   int n_tiles, int bm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bm) return;
  float s = 0.0f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(long long)t * bm + i];
  pool[i] = s;
}

template <int K, bool EXPAND>
int launch(const void* x, const void* we, const void* be, const void* wd, const void* bd, void* y,
           void* partial, void* pool, int nb, int h, int w, int cin, int m, long long xsb,
           long long xsh, long long xsw, long long ysb, long long ysh, long long ysw,
           int with_pool, cudaStream_t stream) {
  const size_t smem = EXPAND ? Geo<K>::kSmemExpand : Geo<K>::kSmemDw;
  cudaError_t err = cudaFuncSetAttribute(mbconv_head_kernel<K, EXPAND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (h + kTH - 1) / kTH, tiles_w = (w + kTW - 1) / kTW;
  const dim3 grid(tiles_h * tiles_w, (m + kMT - 1) / kMT, nb);
  mbconv_head_kernel<K, EXPAND><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)we, (const float*)be, (const bf16*)wd, (const float*)bd,
      (bf16*)y, (float*)partial, nb, h, w, cin, m, xsb, xsh, xsw, ysb, ysh, ysw, tiles_w,
      with_pool);
  err = cudaGetLastError();
  if (err != cudaSuccess || !with_pool) return (int)err;
  const int bm = nb * m;
  pool_reduce_kernel<<<(bm + 255) / 256, 256, 0, stream>>>((const float*)partial, (float*)pool,
                                                           tiles_h * tiles_w, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// x: B images of H x W pixels of Cin bf16 channels at element strides (xsb,
// xsh, xsw), channels contiguous; y the same with M channels at (ysb, ysh,
// ysw). expand != 0: we (Cin, M) bf16 and be (M,) fp32 are the 1x1 expand;
// expand == 0: Cin == M and we, be are unused. wd (k*k, M) bf16, bd (M,)
// fp32. with_pool != 0: partial is scratch of ceil(H/8) ceil(W/16) B M fp32
// and pool (B, M) fp32 gets the spatial sum of the fp32 y. Cin % 8 == 0,
// M % 8 == 0, strides multiples of 8, pointers 16-byte aligned; k is 3 or 5.
// Returns cudaGetLastError() after the launches.
extern "C" int objcavit_mbconv_head(const void* x, const void* we, const void* be, const void* wd,
                                    const void* bd, void* y, void* partial, void* pool, int nb,
                                    int h, int w, int cin, int m, int ksize, long long xsb,
                                    long long xsh, long long xsw, long long ysb, long long ysh,
                                    long long ysw, int expand, int with_pool, void* stream) {
  if (nb == 0 || h == 0 || w == 0 || m == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
#define OBJCAVIT_MBCONV_LAUNCH(K, E)                                                           \
  return launch<K, E>(x, we, be, wd, bd, y, partial, pool, nb, h, w, cin, m, xsb, xsh, xsw, ysb, \
                      ysh, ysw, with_pool, s)
  if (ksize == 3 && expand) OBJCAVIT_MBCONV_LAUNCH(3, true);
  if (ksize == 3) OBJCAVIT_MBCONV_LAUNCH(3, false);
  if (ksize == 5 && expand) OBJCAVIT_MBCONV_LAUNCH(5, true);
  if (ksize == 5) OBJCAVIT_MBCONV_LAUNCH(5, false);
#undef OBJCAVIT_MBCONV_LAUNCH
  return (int)cudaErrorInvalidValue;
}
