// Host-side train augmentation engine of the PyTorch port.
//
// The full per-sample train-time augmentation chain -- random x0.5/x1/x2
// resize, random crop pasted at a random offset onto an ImageNet-mean
// canvas, IoU-overlap box filtering, horizontal flip, GT padding to a
// static bound -- in C++ with a std::thread pool, outside the GIL. Python
// (tinyfaces_tpu_torch/data/native.py, via ctypes) hands over decoded
// uint8 buffers.
//
// A copy of the JAX package's engine (native/tinyfaces_native.cpp, without
// its JPEG-DCT half), built with the same compiler flags so that both give
// the same bytes from the same seed. Semantics mirror the reference's
// processor.py:41-112 and wider_face.py:133-165 (same choice probabilities
// and uniform ranges, C++ PRNG stream).
//
// Built at first use by tinyfaces_tpu_torch/utils/cuda_build.load_host_library.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kMeanPixel[3] = {123, 116, 103};  // int(mean * 255)

struct Box {
  float x1, y1, x2, y2;
};

// Exact 0.5x: 2x2 box average (matches bilinear at factor 0.5 pixel-center
// alignment). Tight inner loop, auto-vectorizes.
void resize_half(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                 int dw) {
  for (int y = 0; y < dh; ++y) {
    const uint8_t* r0 = src + static_cast<size_t>(std::min(2 * y, sh - 1)) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(std::min(2 * y + 1, sh - 1)) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      int x0 = std::min(2 * x, sw - 1) * 3, x1 = std::min(2 * x + 1, sw - 1) * 3;
      for (int c = 0; c < 3; ++c)
        out[x * 3 + c] = static_cast<uint8_t>(
            (r0[x0 + c] + r0[x1 + c] + r1[x0 + c] + r1[x1 + c] + 2) >> 2);
    }
  }
}

// Exact 2x: fixed-weight (1/4, 3/4) bilinear phases.
void resize_double(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                   int dw) {
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * 0.5f - 0.5f;
    int y0 = std::clamp(static_cast<int>(std::floor(fy)), 0, sh - 1);
    int y1 = std::min(y0 + 1, sh - 1);
    int wy = (y % 2 == 1) ? 1 : 3;  // fy frac is .25 or .75 -> weights /4
    if (fy < 0) { y1 = y0; wy = 0; }
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * 0.5f - 0.5f;
      int x0 = std::clamp(static_cast<int>(std::floor(fx)), 0, sw - 1);
      int x1 = std::min(x0 + 1, sw - 1);
      int wx = (x % 2 == 1) ? 1 : 3;
      if (fx < 0) { x1 = x0; wx = 0; }
      for (int c = 0; c < 3; ++c) {
        int top = r0[x0 * 3 + c] * (4 - wx) + r0[x1 * 3 + c] * wx;
        int bot = r1[x0 * 3 + c] * (4 - wx) + r1[x1 * 3 + c] * wx;
        out[x * 3 + c] = static_cast<uint8_t>((top * (4 - wy) + bot * wy + 8) >> 4);
      }
    }
  }
}

// Bilinear resize, uint8 RGB. Half/double-size augmentation quality only.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  if (dh * 2 == sh || dh * 2 + 1 == sh) {
    if (dw * 2 == sw || dw * 2 + 1 == sw) return resize_half(src, sh, sw, dst, dh, dw);
  }
  if (dh == sh * 2 && dw == sw * 2) return resize_double(src, sh, sw, dst, dh, dw);
  const float ys = static_cast<float>(sh) / dh;
  const float xs = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    int y0 = std::clamp(static_cast<int>(std::floor(fy)), 0, sh - 1);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = std::clamp(fy - y0, 0.0f, 1.0f);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * xs - 0.5f;
      int x0 = std::clamp(static_cast<int>(std::floor(fx)), 0, sw - 1);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = std::clamp(fx - x0, 0.0f, 1.0f);
      for (int c = 0; c < 3; ++c) {
        float top = src[(y0 * sw + x0) * 3 + c] * (1 - wx) +
                    src[(y0 * sw + x1) * 3 + c] * wx;
        float bot = src[(y1 * sw + x0) * 3 + c] * (1 - wx) +
                    src[(y1 * sw + x1) * 3 + c] * wx;
        dst[(y * dw + x) * 3 + c] =
            static_cast<uint8_t>(std::lround(top * (1 - wy) + bot * wy));
      }
    }
  }
}

// 1 - IoU with the +1 pixel convention (metrics.py:44-74 semantics).
float rect_dist(const Box& a, const Box& b) {
  float ai = (a.x2 - a.x1 + 1) * (a.y2 - a.y1 + 1);
  float aj = (b.x2 - b.x1 + 1) * (b.y2 - b.y1 + 1);
  float x1 = std::max(a.x1, b.x1), y1 = std::max(a.y1, b.y1);
  float x2 = std::min(a.x2, b.x2), y2 = std::min(a.y2, b.y2);
  float inter = (x2 > x1 && y2 > y1) ? (x2 - x1 + 1) * (y2 - y1 + 1) : 0.0f;
  float denom = ai + aj - inter;
  float iou = denom != 0.0f ? inter / denom : 0.0f;
  if (!std::isfinite(iou)) iou = 0.0f;
  return std::clamp(1.0f - iou, 0.0f, 1.0f);
}

struct Sample {
  const uint8_t* img;
  int h, w;
  const float* boxes;  // (n, 4) x1 y1 x2 y2
  int n_boxes;
};

void augment_one(const Sample& s, int input_h, int input_w, float neg_thresh,
                 int max_gt, uint64_t seed, uint8_t* out_canvas, float* out_gt,
                 uint8_t* out_gt_valid, float* out_paste, uint8_t* out_flip,
                 int32_t* out_n_kept) {
  std::mt19937_64 rng(seed);
  auto uniform = [&rng]() {
    return std::uniform_real_distribution<double>(0.0, 1.0)(rng);
  };
  auto randint = [&rng](int lo, int hi) {  // [lo, hi] inclusive
    return std::uniform_int_distribution<int>(lo, hi)(rng);
  };

  // 1. random resize: p=1/3 half, p=1/3 double (wider_face.py:135-146)
  std::vector<uint8_t> resized;
  const uint8_t* img = s.img;
  int h = s.h, w = s.w;
  float box_scale = 1.0f;
  double r = uniform();
  if (r < 1.0 / 3.0 && std::min(s.h, s.w) >= 2) {
    h = s.h / 2;
    w = s.w / 2;
    resized.resize(static_cast<size_t>(h) * w * 3);
    resize_bilinear(s.img, s.h, s.w, resized.data(), h, w);
    img = resized.data();
    box_scale = 0.5f;
  } else if (r > 2.0 / 3.0) {
    h = s.h * 2;
    w = s.w * 2;
    resized.resize(static_cast<size_t>(h) * w * 3);
    resize_bilinear(s.img, s.h, s.w, resized.data(), h, w);
    img = resized.data();
    box_scale = 2.0f;
  }

  // 2. random crop + random paste (processor.py:41-75)
  int crop_x1 = randint(0, std::max(0, w - input_w));
  int crop_y1 = randint(0, std::max(0, h - input_h));
  int crop_x2 = std::min(w, crop_x1 + input_w);
  int crop_y2 = std::min(h, crop_y1 + input_h);
  int ch = crop_y2 - crop_y1, cw = crop_x2 - crop_x1;
  int px = randint(0, input_w - cw);
  int py = randint(0, input_h - ch);

  for (int y = 0; y < input_h; ++y)
    for (int x = 0; x < input_w; ++x)
      std::memcpy(out_canvas + (y * input_w + x) * 3, kMeanPixel, 3);
  for (int y = 0; y < ch; ++y)
    std::memcpy(out_canvas + ((py + y) * input_w + px) * 3,
                img + ((crop_y1 + y) * w + crop_x1) * 3,
                static_cast<size_t>(cw) * 3);

  out_paste[0] = static_cast<float>(px);
  out_paste[1] = static_cast<float>(py);
  out_paste[2] = static_cast<float>(px + cw);
  out_paste[3] = static_cast<float>(py + ch);

  // 3. box adjust/filter (processor.py:77-112)
  std::vector<Box> kept;
  for (int i = 0; i < s.n_boxes; ++i) {
    Box orig{s.boxes[i * 4 + 0] * box_scale, s.boxes[i * 4 + 1] * box_scale,
             s.boxes[i * 4 + 2] * box_scale, s.boxes[i * 4 + 3] * box_scale};
    Box clip{std::max(orig.x1, static_cast<float>(crop_x1)),
             std::max(orig.y1, static_cast<float>(crop_y1)),
             std::min(orig.x2, static_cast<float>(crop_x2)),
             std::min(orig.y2, static_cast<float>(crop_y2))};
    float overlap = 1.0f - rect_dist(clip, orig);
    Box b{orig.x1 - crop_x1 + px, orig.y1 - crop_y1 + py,
          orig.x2 - crop_x1 + px, orig.y2 - crop_y1 + py};
    b.x1 = std::clamp(b.x1, 0.0f, static_cast<float>(input_w));
    b.y1 = std::clamp(b.y1, 0.0f, static_cast<float>(input_h));
    b.x2 = std::clamp(b.x2, 1.0f, static_cast<float>(input_w));
    b.y2 = std::clamp(b.y2, 1.0f, static_cast<float>(input_h));
    if (b.x2 > b.x1 && b.y2 > b.y1 && overlap >= neg_thresh) kept.push_back(b);
  }

  // 4. horizontal flip (wider_face.py:156-165, +1 MATLAB mirror)
  bool flip = uniform() > 0.5;
  *out_flip = flip ? 1 : 0;
  if (flip) {
    std::vector<uint8_t> rowbuf(static_cast<size_t>(input_w) * 3);
    for (int y = 0; y < input_h; ++y) {
      uint8_t* row = out_canvas + static_cast<size_t>(y) * input_w * 3;
      for (int x = 0; x < input_w; ++x)
        std::memcpy(rowbuf.data() + x * 3, row + (input_w - 1 - x) * 3, 3);
      std::memcpy(row, rowbuf.data(), rowbuf.size());
    }
    for (auto& b : kept) {
      float lx1 = b.x1, lx2 = b.x2;
      b.x1 = input_w - lx2 + 1;
      b.x2 = input_w - lx1 + 1;
    }
  }

  // 5. pad GT to the static bound
  std::memset(out_gt, 0, static_cast<size_t>(max_gt) * 4 * sizeof(float));
  std::memset(out_gt_valid, 0, static_cast<size_t>(max_gt));
  // Surface the pre-cap count so the caller can account for truncation
  // (the reference handles unbounded GT counts, processor.py:213-277).
  *out_n_kept = static_cast<int32_t>(kept.size());
  int n = std::min<int>(kept.size(), max_gt);
  for (int i = 0; i < n; ++i) {
    out_gt[i * 4 + 0] = kept[i].x1;
    out_gt[i * 4 + 1] = kept[i].y1;
    out_gt[i * 4 + 2] = kept[i].x2;
    out_gt[i * 4 + 3] = kept[i].y2;
    out_gt_valid[i] = 1;
  }
}

}  // namespace

extern "C" {

// Single-sample entry (testing / debugging).
void tf_augment_sample(const uint8_t* img, int h, int w, const float* boxes,
                       int n_boxes, int input_h, int input_w, float neg_thresh,
                       int max_gt, uint64_t seed, uint8_t* out_canvas,
                       float* out_gt, uint8_t* out_gt_valid, float* out_paste,
                       uint8_t* out_flip, int32_t* out_n_kept) {
  Sample s{img, h, w, boxes, n_boxes};
  augment_one(s, input_h, input_w, neg_thresh, max_gt, seed, out_canvas,
              out_gt, out_gt_valid, out_paste, out_flip, out_n_kept);
}

// Batched entry: pointer arrays per sample, threaded across the batch.
void tf_augment_batch(int batch, const uint8_t** imgs, const int* hs,
                      const int* ws, const float** boxes, const int* n_boxes,
                      int input_h, int input_w, float neg_thresh, int max_gt,
                      uint64_t seed, int n_threads, uint8_t* out_canvas,
                      float* out_gt, uint8_t* out_gt_valid, float* out_paste,
                      uint8_t* out_flip, int32_t* out_n_kept) {
  const size_t canvas_stride = static_cast<size_t>(input_h) * input_w * 3;
  std::atomic<int> next{0};
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) return;
      Sample s{imgs[i], hs[i], ws[i], boxes[i], n_boxes[i]};
      augment_one(s, input_h, input_w, neg_thresh, max_gt,
                  seed + static_cast<uint64_t>(i) * 0x9E3779B97F4A7C15ULL,
                  out_canvas + i * canvas_stride, out_gt + i * max_gt * 4,
                  out_gt_valid + i * max_gt, out_paste + i * 4, out_flip + i,
                  out_n_kept + i);
    }
  };
  int nt = std::max(1, std::min(n_threads, batch));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& th : threads) th.join();
}

// ABI version checked by the bindings (data/native.py); the same number
// as the JAX package's library, whose augmentation entry points these are.
int tf_version() { return 7; }

}  // extern "C"
