// lvt_data: the host side of the port's data path, in C++ with a plain C
// interface, loaded with ctypes by larvanet_tpu_torch/data/native.py.
//
// Two hot spots of the loaders and the server run here instead of in
// Python:
//
//   lvt_unfilter     undoes the five PNG row filters (None, Sub, Up,
//                    Average, Paeth) of a whole inflated image, or of one
//                    Adam7 pass. The port keeps zlib's inflate in Python
//                    (no libpng and no zlib here); Average and Paeth make
//                    each byte depend on the reconstructed byte to its
//                    left, which Python can only walk one byte at a time.
//   lvt_patch_batch  assembles an augmented batch of LR / HR patch pairs
//                    (crop aligned to the scale, rot90 by k in 1..4, a
//                    horizontal flip with p 0.5) straight into float32
//                    NHWC buffers. It is the JAX package's batcher
//                    (native/lvt_data.cpp:84-166) draw for draw: the same
//                    splitmix64 stream, seeded per sample by
//                    seed ^ (0xABCDEF12345678 + b), `below(n)` as
//                    next() % n, the same crop, rotation and flip, the
//                    same return codes. A sample depends on (seed, b)
//                    alone, so the split over threads changes nothing.
//
// Built by ops/build.py's host entry: g++ -O3 -fPIC -shared -std=c++17
// -pthread, at first use, into build/host/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// splitmix64: one step of the per-sample stream
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() { return s = splitmix64(s); }
  int below(int n) { return static_cast<int>(next() % static_cast<uint64_t>(n)); }
};

// A p x p crop of an HWC uint8 image at (y0, x0), rotated by rot90(k)
// (counterclockwise in (H, W), numpy's) then flipped along W, as float32 HWC.
void write_patch(const uint8_t* img, int img_w, int y0, int x0, int p, int k, bool flip,
                 float* out) {
  for (int oy = 0; oy < p; ++oy) {
    for (int ox = 0; ox < p; ++ox) {
      const int fx = flip ? p - 1 - ox : ox;  // undo the flip
      int ry, rx;                             // the coordinate in the crop
      switch (k & 3) {
        case 0: ry = oy; rx = fx; break;
        case 1: ry = fx; rx = p - 1 - oy; break;
        case 2: ry = p - 1 - oy; rx = p - 1 - fx; break;
        default: ry = p - 1 - fx; rx = oy; break;
      }
      const uint8_t* src = img + (static_cast<size_t>(y0 + ry) * img_w + (x0 + rx)) * 3;
      float* dst = out + (static_cast<size_t>(oy) * p + ox) * 3;
      dst[0] = src[0];
      dst[1] = src[1];
      dst[2] = src[2];
    }
  }
}

}  // namespace

extern "C" {

// Undo the row filters of `height` rows: raw holds each row's filter byte
// and its `stride` filtered bytes ((height, 1 + stride) uint8); out gets the
// reconstructed rows ((height, stride) uint8); bpp is the filter distance in
// bytes (PNG's bytes a pixel, at least 1). Returns 0, -1 on bad arguments,
// or 1 + y for a row y whose filter byte is not 0-4.
int lvt_unfilter(const uint8_t* raw, int height, int stride, int bpp, uint8_t* out) {
  if (height < 0 || stride < 0 || bpp < 1) return -1;
  const uint8_t* prev = nullptr;  // the row above: zeros for the first
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
    const int kind = line[0];
    ++line;
    uint8_t* cur = out + static_cast<size_t>(y) * stride;
    switch (kind) {
      case 0:
        for (int i = 0; i < stride; ++i) cur[i] = line[i];
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = prev && i >= bpp ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + paeth(a, b, c));
        }
        break;
      default:
        return 1 + y;
    }
    prev = cur;
  }
  return 0;
}

// Assemble an augmented patch batch. Returns 0; -1 on bad arguments; -2 if a
// sample drew an image whose LR side is not larger than the patch (its
// output is left unwritten; the other samples are written).
//   lr_imgs, hr_imgs: per-image RGB8 HWC pointers (HR dims = LR dims * scale)
//   lr_dims: [h0, w0, h1, w1, ...] of the LR images
//   out_lr: float32 [batch, patch, patch, 3]; out_hr: float32 [batch, p s, p s, 3]
int lvt_patch_batch(const uint8_t** lr_imgs, const uint8_t** hr_imgs, const int* lr_dims,
                    int num_images, int batch, int patch, int scale, uint64_t seed,
                    float* out_lr, float* out_hr, int num_threads) {
  if (num_images <= 0 || batch <= 0 || patch <= 0 || scale <= 0) return -1;
  if (num_threads <= 0) num_threads = 1;
  std::atomic<int> bad{0};
  auto worker = [&](int b0, int b1) {
    for (int b = b0; b < b1; ++b) {
      Rng rng(splitmix64(seed ^ (0xABCDEF12345678ull + static_cast<uint64_t>(b))));
      const int idx = rng.below(num_images);
      const int h = lr_dims[2 * idx], w = lr_dims[2 * idx + 1];
      if (h <= patch || w <= patch) {
        bad.store(b + 1);
        continue;
      }
      const int y0 = rng.below(h - patch);
      const int x0 = rng.below(w - patch);
      const int k = rng.below(4) + 1;
      const bool flip = (rng.next() & 1) != 0;
      const int hp = patch * scale;
      write_patch(lr_imgs[idx], w, y0, x0, patch, k, flip,
                  out_lr + static_cast<size_t>(b) * patch * patch * 3);
      write_patch(hr_imgs[idx], w * scale, y0 * scale, x0 * scale, hp, k, flip,
                  out_hr + static_cast<size_t>(b) * hp * hp * 3);
    }
  };
  const int threads = std::min(num_threads, batch);
  const int per = (batch + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) {
    const int lo = t * per, hi = std::min(lo + per, batch);
    if (lo < hi) pool.emplace_back(worker, lo, hi);
  }
  worker(0, std::min(per, batch));  // the calling thread takes the first share
  for (auto& th : pool) th.join();
  return bad.load() ? -2 : 0;
}

}  // extern "C"
