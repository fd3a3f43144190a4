// preprocess.cpp — the host core: the data loader's per-sample image work.
//
// A copy of the JAX package's csrc/preprocess.cpp, whose code it keeps line
// for line, so that with the same compiler and flags it computes the same
// bits. The reference runs this work with PIL, numpy and kornia inside torch
// DataLoader workers; here the loader's hot inner loops run in C++, bound with
// ctypes by objcavit_torch/data/native.py:
//
//   * rotate_bilinear_f32 / rotate_nearest_f32 — rotation about the image
//     centre with zero fill (kornia RandomRotation semantics used by the
//     new-path Preprocess; the legacy path uses PIL and stays in PIL)
//   * augment_normalize_f32 — fused flip + gamma + brightness + per-channel
//     colour + clip + ImageNet normalisation (the legacy old_dl train tail,
//     dataloader.py:237-284) in one pass over the image
//   * hflip_f32, and assemble_batch_f32 — crop + that tail + stack for a
//     whole batch, over std::threads (sample i on thread i mod n)
//
// Build: objcavit_torch/kernels/build.py::build_host compiles it with g++
// (-O3 -march=native -ffast-math) into objcavit_torch/_build/
// libobjcavit_preprocess.so at first use. Pure C ABI, float32, HWC row-major
// buffers allocated by the caller.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Rotate HWC float32 image by `angle_deg` about the centre, bilinear taps,
// zero fill outside. out must be HxWxC.
void rotate_bilinear_f32(const float* in, float* out, int64_t h, int64_t w,
                         int64_t c, float angle_deg) {
  const float a = angle_deg * (float)(M_PI / 180.0);
  const float cos_a = std::cos(a), sin_a = std::sin(a);
  const float cx = (w - 1) * 0.5f, cy = (h - 1) * 0.5f;
  for (int64_t y = 0; y < h; ++y) {
    const float y0 = (float)y - cy;
    for (int64_t x = 0; x < w; ++x) {
      const float x0 = (float)x - cx;
      const float sx = cos_a * x0 + sin_a * y0 + cx;
      const float sy = -sin_a * x0 + cos_a * y0 + cy;
      float* o = out + (y * w + x) * c;
      const int64_t xl = (int64_t)std::floor(sx);
      const int64_t yl = (int64_t)std::floor(sy);
      const float fx = sx - xl, fy = sy - yl;
      for (int64_t ch = 0; ch < c; ++ch) o[ch] = 0.f;
      for (int dy = 0; dy <= 1; ++dy) {
        const int64_t yy = yl + dy;
        if (yy < 0 || yy >= h) continue;
        const float wy = dy ? fy : 1.f - fy;
        for (int dx = 0; dx <= 1; ++dx) {
          const int64_t xx = xl + dx;
          if (xx < 0 || xx >= w) continue;
          const float wgt = wy * (dx ? fx : 1.f - fx);
          const float* p = in + (yy * w + xx) * c;
          for (int64_t ch = 0; ch < c; ++ch) o[ch] += wgt * p[ch];
        }
      }
    }
  }
}

// Nearest-neighbour rotation (depth maps), zero fill.
void rotate_nearest_f32(const float* in, float* out, int64_t h, int64_t w,
                        int64_t c, float angle_deg) {
  const float a = angle_deg * (float)(M_PI / 180.0);
  const float cos_a = std::cos(a), sin_a = std::sin(a);
  const float cx = (w - 1) * 0.5f, cy = (h - 1) * 0.5f;
  for (int64_t y = 0; y < h; ++y) {
    const float y0 = (float)y - cy;
    for (int64_t x = 0; x < w; ++x) {
      const float x0 = (float)x - cx;
      const float sx = cos_a * x0 + sin_a * y0 + cx;
      const float sy = -sin_a * x0 + cos_a * y0 + cy;
      const int64_t xx = (int64_t)std::nearbyint(sx);
      const int64_t yy = (int64_t)std::nearbyint(sy);
      float* o = out + (y * w + x) * c;
      if (xx < 0 || xx >= w || yy < 0 || yy >= h) {
        for (int64_t ch = 0; ch < c; ++ch) o[ch] = 0.f;
      } else {
        const float* p = in + (yy * w + xx) * c;
        for (int64_t ch = 0; ch < c; ++ch) o[ch] = p[ch];
      }
    }
  }
}

// Fused legacy-train-tail: optional horizontal flip, gamma, brightness,
// per-channel colour gains, clip to [0,1], ImageNet normalisation. In-place
// over a HxWx3 float32 image in [0,1]. `do_augment` gates gamma/bright/col.
void augment_normalize_f32(float* img, int64_t h, int64_t w, int flip,
                           int do_augment, float gamma, float brightness,
                           const float* color3, int do_normalize) {
  static const float kMean[3] = {0.485f, 0.456f, 0.406f};
  static const float kStd[3] = {0.229f, 0.224f, 0.225f};
  const int64_t n = h * w;
  if (flip) {
    for (int64_t y = 0; y < h; ++y) {
      float* row = img + y * w * 3;
      for (int64_t x = 0; x < w / 2; ++x) {
        float* a = row + x * 3;
        float* b = row + (w - 1 - x) * 3;
        for (int ch = 0; ch < 3; ++ch) std::swap(a[ch], b[ch]);
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    float* p = img + i * 3;
    for (int ch = 0; ch < 3; ++ch) {
      float v = p[ch];
      if (do_augment) {
        v = std::pow(std::max(v, 0.f), gamma) * brightness * color3[ch];
        v = std::min(std::max(v, 0.f), 1.f);
      }
      if (do_normalize) v = (v - kMean[ch]) / kStd[ch];
      p[ch] = v;
    }
  }
}

// Flip a HWC float32 buffer horizontally (depth maps alongside images).
void hflip_f32(float* img, int64_t h, int64_t w, int64_t c) {
  for (int64_t y = 0; y < h; ++y) {
    float* row = img + y * w * c;
    for (int64_t x = 0; x < w / 2; ++x) {
      float* a = row + x * c;
      float* b = row + (w - 1 - x) * c;
      for (int64_t ch = 0; ch < c; ++ch) std::swap(a[ch], b[ch]);
    }
  }
}

// ---------------------------------------------------------------------------
// Batch assembler: per-sample random-crop + the fused legacy augment tail +
// depth crop/flip, written straight into contiguous (N, out_h, out_w, C)
// batch buffers, parallelised over samples with std::thread. This is the
// loader's batch-assembly hot loop (crop -> flip/gamma/colour/normalise ->
// stack) as ONE native pass — the torch-DataLoader-worker replacement at
// batch granularity. Math is identical to crop + augment_normalize_f32 +
// hflip_f32 run per sample (the parity tests assert bit-equality).

static void assemble_one(const float* img, const float* dep, int64_t h,
                         int64_t w, int64_t out_h, int64_t out_w,
                         int32_t crop_y, int32_t crop_x, int32_t flip,
                         int32_t do_augment, float gamma, float brightness,
                         const float* color3, int do_normalize,
                         float* img_slot, float* dep_slot) {
  for (int64_t y = 0; y < out_h; ++y) {
    const float* src = img + ((crop_y + y) * w + crop_x) * 3;
    std::memcpy(img_slot + y * out_w * 3, src, sizeof(float) * out_w * 3);
    const float* dsrc = dep + ((crop_y + y) * w + crop_x) * 1;
    std::memcpy(dep_slot + y * out_w, dsrc, sizeof(float) * out_w);
  }
  augment_normalize_f32(img_slot, out_h, out_w, flip, do_augment, gamma,
                        brightness, color3, do_normalize);
  if (flip) hflip_f32(dep_slot, out_h, out_w, 1);
}

// imgs/deps: n pointers to HxWx3 / HxWx1 float32 (post-rotate, pre-crop).
// out_imgs: (n, out_h, out_w, 3); out_deps: (n, out_h, out_w, 1).
void assemble_batch_f32(const float* const* imgs, const float* const* deps,
                        int64_t n, const int64_t* hs, const int64_t* ws,
                        int64_t out_h, int64_t out_w, const int32_t* crop_y,
                        const int32_t* crop_x, const int32_t* flips,
                        const int32_t* do_augments, const float* gammas,
                        const float* brightnesses, const float* colors3,
                        int do_normalize, int n_threads, float* out_imgs,
                        float* out_deps) {
  const int workers =
      std::max(1, std::min<int>(n_threads, static_cast<int>(n)));
  auto work = [&](int tid) {
    for (int64_t i = tid; i < n; i += workers) {
      assemble_one(imgs[i], deps[i], hs[i], ws[i], out_h, out_w, crop_y[i],
                   crop_x[i], flips[i], do_augments[i], gammas[i],
                   brightnesses[i], colors3 + i * 3, do_normalize,
                   out_imgs + i * out_h * out_w * 3,
                   out_deps + i * out_h * out_w);
    }
  };
  if (workers == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

}  // extern "C"
