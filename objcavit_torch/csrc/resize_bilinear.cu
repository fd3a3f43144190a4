// Bilinear upsample with align_corners=True of an NHWC bf16 tensor, written
// either alone or straight into its channel slice of the decoder's concat
// buffer, with the skip copied into the other slice by the same launch.
//
// Replaces the TPU kernel objcavit_tpu/ops/resize_pallas.py::
// resize_bilinear_pallas (_kernel): the decoder's four skip upsamples
// (objcavit_tpu/models/decoder.py:91-98). The JAX decoder keeps the concat
// of the upsample and its skip out of memory by splitting the next conv
// along its input channels (ConcatSplitConv); on this card the concat form
// does it instead: the upsample and the skip land once in the one buffer the
// conv reads, and no torch.cat reads and writes them again.
//
// What bounds it on the H100: bytes. The input (and skip) read once and the
// output written once; six fp32 flops per output element. At the flagship's
// batch of 8 the four upsamples read ~150 MB and write ~590 MB, and the
// concat form adds the skips' ~50 MB read and written.
//
// What the first port's design lost, and what this one does about it. It ran one
// thread per 16-byte output vector over a flat index: each thread recovered
// (b, oy, ox, channel group) by three 64-bit divisions and remainders
// (emulated in software, tens of instructions each), read six tap-table
// entries, and gathered four 16-byte tap vectors from L2, so ~2.4 GB moved
// from L2 to the SMs to write 590 MB, and it reached 48% of its bound.
// Here:
// - A 3-D grid: x = (column strip, channel slice), y = band of output rows,
//   z = image. A block finds its place by one 32-bit division of
//   blockIdx.x; inside, thread j of a row takes column j / CV and vector
//   j % CV with CV a power of two known at compile time. Nothing divides by
//   a runtime value in the loops but the skip copy's pixel index (32-bit).
// - Input rows land in shared memory by cp.async of 16-byte vectors, each
//   row of a band once: a ring of four row slots, tagged with the input row
//   they hold. The row taps are monotone in the output row, so the rows of
//   output row oy + 1 are mostly rows already held; the missing ones load
//   into slots that row oy does not read while row oy is computed.
// - The H lerp runs once per (output row, input column) in fp32 into a
//   shared row; the W lerp reads it there. Each input element thus crosses
//   from L2 about once per band instead of four times per output.
// - The block's W taps are staged in shared memory; an output row reads its
//   H taps once.
// - Every load and store is a 16-byte vector; neighbouring threads cover
//   neighbouring channel groups of a pixel and then neighbouring pixels.
// - The concat form: the slices' blocks of a strip share out its pixels'
//   skip, each prefetching its part of the next row's skip with the input
//   rows (three skip slots) and storing it beside its own channels. A
//   pixel's record of C + Cs channels is not always a whole number of
//   32-byte sectors (1104 and 560 bytes at the B5 decoder's up3 and up4);
//   a sector that two blocks write is merged in L2 only if both halves
//   arrive before it is evicted. A lone skip block that ran ahead of the
//   slices' blocks, and then 64-channel slices, made the concat form 1.5-2x
//   slower than the bare upsample on an H100; row by row within the blocks
//   and slices of up to 256 channels (long runs of each record from one
//   block) bring it within the skip's own bytes of it.
// Shared memory of a block: 4 raw rows of `cols` input columns x slice
// channels in bf16, plus one H-lerped row in fp32: cols x slice x 12 bytes;
// three skip rows of the block's share of the strip's pixels; 12 bytes a
// strip column for the W taps. kernels/resize.py::resize_plan picks the
// slice (256 channels where C allows), the strip of output columns whose
// input span fits (at most 55 KB a block: four blocks of 256 threads an
// SM, which __launch_bounds__ holds to 64 registers) and the band (4 rows).
//
// The row-window form (spatial serving, objcavit_torch/parallel/spatial.py):
// a rank that serves a band of the image's rows writes only the output rows
// [row_lo, row_hi) of the Ho-row upsample of the whole low-resolution input,
// beside its band of the skip. Output row y reads input rows y (Hi - 1) /
// (Ho - 1) of the whole input, so x is whole (the decoder gathers it: it
// holds a quarter of the output's pixels) and the window is the H tap
// tables from row_lo on: the same kernel, on row_hi - row_lo output rows.
// Its bound is the window's bytes: the input rows its taps reach, read
// once, and the window's output (and skip) rows.
//
// Arithmetic, as the plain version in objcavit_torch/ops/resize.py: H lerp
// then W lerp, in fp32, rounded to bf16 once. Row and column taps (lo, hi,
// frac) are computed on the host in float64 (ops/resize.py::interp_taps):
// o*(in-1)/(out-1) in float32 here could put floor() on the wrong side of an
// integer. The TPU kernel's dense (Wo, Wi) matrix product, its W padding and
// its bf16 rounding between the H and W passes existed for the TPU's layout
// and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kSlots = 4;  // input rows held in shared memory
constexpr int kMaxSmem = 232448;

struct Geometry {
  int hi, wi, c, cs, ho, wo;
  int ctot;       // channels of a destination pixel: c + cs
  int slices;     // channel slices of x: c / (8 CV)
  int strips;     // column strips: ceil(wo / strip_w)
  int strip_w;    // output columns of a strip
  int cols;       // input columns a strip may read: the shared row width
  int band_rows;  // output rows of a band
  int skip_px;    // skip pixels of a strip row each slice's block copies: ceil(strip_w / slices)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the slot that holds input row r, or -1
__device__ __forceinline__ int find_slot(const int (&tag)[kSlots], int r) {
  int s = -1;
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
    if (tag[i] == r) s = i;
  return s;
}

// a slot for input row r: the one that holds it, else the first slot none of
// `busy0`, `busy1`, `busy2` names (filled by the caller; four slots leave
// one free whatever the three name)
__device__ __forceinline__ int claim_slot(int (&tag)[kSlots], int r, int busy0, int busy1,
                                          int busy2, bool& fresh) {
  int s = find_slot(tag, r);
  fresh = s < 0;
  if (fresh) {
#pragma unroll
    for (int i = kSlots - 1; i >= 0; --i)
      if (i != busy0 && i != busy1 && i != busy2) s = i;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (i == s) tag[i] = r;
  }
  return s;
}

template <int CV>
__global__ void __launch_bounds__(kThreads, 4) resize_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ skip, bf16* __restrict__ y,
    const int* __restrict__ h_lo, const int* __restrict__ h_hi, const float* __restrict__ h_frac,
    const int* __restrict__ w_lo, const int* __restrict__ w_hi, const float* __restrict__ w_frac,
    const Geometry g) {
  constexpr int CS = 8 * CV;  // channels of a slice
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * g.band_rows;
  const int oy1 = min(oy0 + g.band_rows, g.ho);
  const int strip = blockIdx.x / g.slices;
  const int slice = blockIdx.x - strip * g.slices;
  const int c0 = slice * CS;
  // each slice's block also copies the skip of skip_px of the strip's
  // pixels, row by row beside its own channels: a pixel's record (C + Cs
  // channels, not always a whole number of 32-byte sectors) is then written
  // by neighbouring blocks at about the same time, and L2 merges its partly
  // written sectors before they reach memory
  const int csv = g.cs / 8;
  const int ox0 = strip * g.strip_w;
  const int nox = min(g.strip_w, g.wo - ox0);
  const int ix0 = __ldg(w_lo + ox0);
  const int ncol = __ldg(w_hi + ox0 + nox - 1) - ix0 + 1;  // <= g.cols (resize_plan)
  const int px0 = slice * g.skip_px;
  const int npx = skip == nullptr ? 0 : max(0, min(g.skip_px, nox - px0));
  const bool copies_skip = npx > 0;

  bf16* raw = reinterpret_cast<bf16*>(smem);                       // [kSlots][cols][CS]
  float* hrow = reinterpret_cast<float*>(raw + kSlots * g.cols * CS);  // [cols][CS]
  bf16* sbuf = reinterpret_cast<bf16*>(hrow + g.cols * CS);  // [3][skip_px][cs]: skip rows
  int* tlo = reinterpret_cast<int*>(sbuf + 3 * g.skip_px * g.cs);      // [strip_w], from ix0
  int* thi = tlo + g.strip_w;
  float* tfr = reinterpret_cast<float*>(thi + g.strip_w);
  for (int i = tid; i < nox; i += kThreads) {
    tlo[i] = __ldg(w_lo + ox0 + i) - ix0;
    thi[i] = __ldg(w_hi + ox0 + i) - ix0;
    tfr[i] = __ldg(w_frac + ox0 + i);
  }

  const bf16* img = x + (size_t)b * g.hi * g.wi * g.c + (size_t)ix0 * g.c + c0;
  auto load_row = [&](int slot, int row) {
    const bf16* src = img + (size_t)row * g.wi * g.c;
    bf16* dst = raw + slot * g.cols * CS;
    for (int j = tid; j < ncol * CV; j += kThreads) {
      const int col = j / CV, v = j % CV;
      cp_async16(dst + col * CS + v * 8, src + (size_t)col * g.c + v * 8);
    }
  };

  // the skip of output row oy, this block's pixels (contiguous in skip),
  // into skip slot k
  const bf16* skip_src = copies_skip ? skip + ((size_t)b * g.ho * g.wo + ox0 + px0) * g.cs : nullptr;
  auto load_skip = [&](int k, int oy) {
    const bf16* src = skip_src + (size_t)oy * g.wo * g.cs;
    bf16* dst = sbuf + k * g.skip_px * g.cs;
    for (int j = tid; j < npx * csv; j += kThreads) cp_async16(dst + j * 8, src + j * 8);
  };

  int tag[kSlots] = {-1, -1, -1, -1};
  bool fresh;
  const int first0 = __ldg(h_lo + oy0), first1 = __ldg(h_hi + oy0);
  int s0 = claim_slot(tag, first0, -1, -1, -1, fresh);
  if (fresh) load_row(s0, first0);
  int s1 = claim_slot(tag, first1, s0, -1, -1, fresh);
  if (fresh) load_row(s1, first1);
  if (copies_skip) load_skip(0, oy0);
  cp_async_commit();
  int sk = 0;  // this row's skip slot: (oy - oy0) % 3

  bf16* out = y + ((size_t)b * g.ho * g.wo + ox0) * g.ctot + c0;
  for (int oy = oy0; oy < oy1; ++oy) {
    // the next row's input rows, into slots this row does not read
    int n0 = s0, n1 = s1;
    if (oy + 1 < oy1) {
      const int r0 = __ldg(h_lo + oy + 1), r1 = __ldg(h_hi + oy + 1);
      n0 = claim_slot(tag, r0, s0, s1, -1, fresh);
      if (fresh) load_row(n0, r0);
      n1 = claim_slot(tag, r1, s0, s1, n0, fresh);
      if (fresh) load_row(n1, r1);
      // three skip slots: the next row's fills the one neither this row
      // nor (in a thread still finishing it) the last one reads
      if (copies_skip) load_skip(sk == 2 ? 0 : sk + 1, oy + 1);
    }
    cp_async_commit();
    cp_async_wait_1();  // this row's input rows have landed (each thread's own copies)
    __syncthreads();    // ... and everyone's

    // H lerp, once per input column of the strip
    const float fy = __ldg(h_frac + oy);
    const bf16* top = raw + s0 * g.cols * CS;
    const bf16* bot = raw + s1 * g.cols * CS;
    for (int j = tid; j < ncol * CV; j += kThreads) {
      const int at = (j / CV) * CS + (j % CV) * 8;
      const uint4 ut = *reinterpret_cast<const uint4*>(top + at);
      const uint4 ub = *reinterpret_cast<const uint4*>(bot + at);
      const __nv_bfloat162* pt = reinterpret_cast<const __nv_bfloat162*>(&ut);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&ub);
      float h[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 t = __bfloat1622float2(pt[e]);
        const float2 u = __bfloat1622float2(pb[e]);
        h[2 * e] = t.x * (1.0f - fy) + u.x * fy;
        h[2 * e + 1] = t.y * (1.0f - fy) + u.y * fy;
      }
      float4* dst = reinterpret_cast<float4*>(hrow + at);
      dst[0] = make_float4(h[0], h[1], h[2], h[3]);
      dst[1] = make_float4(h[4], h[5], h[6], h[7]);
    }
    __syncthreads();

    // W lerp from the shared row, 16 bytes a store
    bf16* orow = out + (size_t)oy * g.wo * g.ctot;
    for (int j = tid; j < nox * CV; j += kThreads) {
      const int ox = j / CV, v = j % CV;
      const float fx = tfr[ox];
      const float4* l = reinterpret_cast<const float4*>(hrow + tlo[ox] * CS + v * 8);
      const float4* r = reinterpret_cast<const float4*>(hrow + thi[ox] * CS + v * 8);
      const float4 l0 = l[0], l1 = l[1], r0 = r[0], r1 = r[1];
      uint4 packed;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
      o[0] = __floats2bfloat162_rn(l0.x * (1.0f - fx) + r0.x * fx, l0.y * (1.0f - fx) + r0.y * fx);
      o[1] = __floats2bfloat162_rn(l0.z * (1.0f - fx) + r0.z * fx, l0.w * (1.0f - fx) + r0.w * fx);
      o[2] = __floats2bfloat162_rn(l1.x * (1.0f - fx) + r1.x * fx, l1.y * (1.0f - fx) + r1.y * fx);
      o[3] = __floats2bfloat162_rn(l1.z * (1.0f - fx) + r1.z * fx, l1.w * (1.0f - fx) + r1.w * fx);
      *reinterpret_cast<uint4*>(orow + (size_t)ox * g.ctot + v * 8) = packed;
    }
    if (copies_skip) {
      const bf16* src = sbuf + sk * g.skip_px * g.cs;
      bf16* dst = orow + (size_t)px0 * g.ctot + (g.c - c0);
      for (int j = tid; j < npx * csv; j += kThreads) {
        const int pix = j / csv;
        *reinterpret_cast<uint4*>(dst + (size_t)pix * g.ctot + (j - pix * csv) * 8) =
            *reinterpret_cast<const uint4*>(src + j * 8);
      }
    }
    sk = sk == 2 ? 0 : sk + 1;
    s0 = n0;
    s1 = n1;
  }
}

size_t smem_bytes(int slice_c, int cols, int strip_w, int skip_px, int cs) {
  return (size_t)cols * slice_c * (2 * kSlots + 4) + (size_t)skip_px * 6 * cs + (size_t)strip_w * 12;
}

template <int CV>
int launch(const void* x, const void* skip, void* y, const void* const* taps, const Geometry& g,
           int b, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        resize_kernel<CV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(g.slices * g.strips, (g.ho + g.band_rows - 1) / g.band_rows, b);
  resize_kernel<CV><<<grid, kThreads, smem_bytes(8 * CV, g.cols, g.strip_w, g.skip_px, g.cs),
                      stream>>>(
      (const bf16*)x, (const bf16*)skip, (bf16*)y, (const int*)taps[0], (const int*)taps[1],
      (const float*)taps[2], (const int*)taps[3], (const int*)taps[4], (const float*)taps[5], g);
  return (int)cudaGetLastError();
}

int resize(const void* x, const void* skip, void* y, const void* const* taps, int b, int hi,
           int wi, int c, int cs, int ho, int wo, int slice_c, int strip_w, int cols,
           int band_rows, void* stream) {
  if (b == 0 || ho == 0 || wo == 0) return (int)cudaSuccess;
  if (b < 0 || b > 65535 || hi <= 0 || wi <= 0 || c <= 0 || c % 8 || cs < 0 || cs % 8 ||
      (skip == nullptr) != (cs == 0) || ho < 0 || wo < 0 ||
      slice_c < 8 || slice_c > 512 || (slice_c & (slice_c - 1)) || c % slice_c ||
      strip_w <= 0 || cols <= 0 || band_rows <= 0 ||
      smem_bytes(slice_c, cols, strip_w, (strip_w + c / slice_c - 1) / (c / slice_c), cs) >
          (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.hi = hi;
  g.wi = wi;
  g.c = c;
  g.cs = cs;
  g.ho = ho;
  g.wo = wo;
  g.ctot = c + cs;
  g.slices = c / slice_c;
  g.strip_w = strip_w;
  g.strips = (wo + strip_w - 1) / strip_w;
  g.cols = cols;
  g.band_rows = band_rows;
  g.skip_px = (strip_w + g.slices - 1) / g.slices;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (slice_c) {
    case 512: return launch<64>(x, skip, y, taps, g, b, s);
    case 256: return launch<32>(x, skip, y, taps, g, b, s);
    case 128: return launch<16>(x, skip, y, taps, g, b, s);
    case 64: return launch<8>(x, skip, y, taps, g, b, s);
    case 32: return launch<4>(x, skip, y, taps, g, b, s);
    case 16: return launch<2>(x, skip, y, taps, g, b, s);
    default: return launch<1>(x, skip, y, taps, g, b, s);
  }
}

}  // namespace

// x (B, Hi, Wi, C) and y (B, Ho, Wo, C), contiguous bf16, C % 8 == 0, both
// 16-byte aligned; taps are int32 / float32 device tables of length Ho and
// Wo; slice_c, strip_w, cols and band_rows are kernels/resize.py::
// resize_plan's (every strip of strip_w output columns reads at most cols
// input columns). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int objcavit_resize_bilinear_ac_nhwc_bf16(
    const void* x, void* y, const void* h_lo, const void* h_hi, const void* h_frac,
    const void* w_lo, const void* w_hi, const void* w_frac, int b, int hi, int wi, int c, int ho,
    int wo, int slice_c, int strip_w, int cols, int band_rows, void* stream) {
  const void* taps[6] = {h_lo, h_hi, h_frac, w_lo, w_hi, w_frac};
  return resize(x, nullptr, y, taps, b, hi, wi, c, 0, ho, wo, slice_c, strip_w, cols, band_rows,
                stream);
}

// The concat form: y (B, Ho, Wo, C + Cs) gets the upsample of x in channels
// [0, C) and skip (B, Ho, Wo, Cs) in channels [C, C + Cs), bit for bit;
// Cs % 8 == 0, Cs > 0, the rest as above.
extern "C" int objcavit_resize_bilinear_ac_concat_bf16(
    const void* x, const void* skip, void* y, const void* h_lo, const void* h_hi,
    const void* h_frac, const void* w_lo, const void* w_hi, const void* w_frac, int b, int hi,
    int wi, int c, int cs, int ho, int wo, int slice_c, int strip_w, int cols, int band_rows,
    void* stream) {
  if (cs <= 0) return (int)cudaErrorInvalidValue;
  const void* taps[6] = {h_lo, h_hi, h_frac, w_lo, w_hi, w_frac};
  return resize(x, skip, y, taps, b, hi, wi, c, cs, ho, wo, slice_c, strip_w, cols, band_rows,
                stream);
}

// The row-window form: y (B, row_hi - row_lo, Wo, C + Cs) gets output rows
// [row_lo, row_hi) of the upsample of x to (ho, wo) in channels [0, C) and,
// where skip is not null, skip (B, row_hi - row_lo, Wo, Cs) in [C, C + Cs)
// (Cs = 0 without it); the taps are the whole (ho, wo) tables, the plan
// resize_plan's for the window's rows. 0 <= row_lo <= row_hi <= ho.
extern "C" int objcavit_resize_bilinear_ac_window_bf16(
    const void* x, const void* skip, void* y, const void* h_lo, const void* h_hi,
    const void* h_frac, const void* w_lo, const void* w_hi, const void* w_frac, int b, int hi,
    int wi, int c, int cs, int ho, int wo, int row_lo, int row_hi, int slice_c, int strip_w,
    int cols, int band_rows, void* stream) {
  if (row_lo < 0 || row_hi < row_lo || row_hi > ho) return (int)cudaErrorInvalidValue;
  const void* taps[6] = {(const int*)h_lo + row_lo, (const int*)h_hi + row_lo,
                         (const float*)h_frac + row_lo, w_lo, w_hi, w_frac};
  return resize(x, skip, y, taps, b, hi, wi, c, cs, row_hi - row_lo, wo, slice_c, strip_w, cols,
                band_rows, stream);
}
