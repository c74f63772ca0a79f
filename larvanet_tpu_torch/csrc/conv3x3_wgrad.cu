// Weight and bias gradient of the SAME 3x3 convolution, NHWC x HWIO, f32,
// for Hopper.
//
// Replaces XLA's weight gradient of `conv3x3` (larvanet_tpu/models/layers.py:81,
// a flax nn.Conv that the JAX package trains through jax.grad; no Pallas
// kernel has a backward, so the training graph reaches no pallas_call). In
// the port it is the third kernel of a train step's conv, beside the forward
// and the input gradient, which both run conv3x3_bias_act.cu
// (ops/conv3x3.py `Conv3x3Train`). For x (N, H, W, C) and the gradient g of
// the conv's output before its bias, (N, H, W, F):
//
//   dW[ky, kx, c, f] = sum over n, h, w of x_pad[n, h + ky, w + kx, c] * g[n, h, w, f]
//   db[f]            = sum over n, h, w of g[n, h, w, f]
//
// with x_pad the SAME halo of zeros. As a matrix product it is
// out = A^T g with K = N*H*W pixels: A's rows are the virtual im2col rows of
// x (9 C values a pixel, tap-major and channel-minor, the HWIO kernel's
// order) followed by a column of ones, so `out` (9 C + 1, F) holds dW as the
// HWIO kernel reshaped to (9 C, F) and db as its last row.
//
// The reduction is long and the output small: K is 36,864 for EDSR's trunk
// at batch 16 x 48x48 (out 577 x 64) and 589,824 for final_conv's 64 -> 3 at
// 192x192 (out 577 x 3). Every entry therefore splits K across blocks
// (gridDim.z splits, chosen by the wrapper for the card's SM count,
// ops/conv3x3_wgrad.py `tile_splits`, `splits_for`), each block writing its partial sums to
// a workspace, and a second kernel adds the partials in split order. No
// float atomics, and every sum in a fixed order: the result is the same bit
// for bit on every run, which a resumed training run needs to repeat an
// uninterrupted one.
//
// Bounds on an H100 SXM (f32-accurate products at 495 / 3 = 165 TFLOP/s in
// split TF32, 3.35 TB/s), batch 16: the trunk's 64 -> 64 at 48x48 is 2.72
// GFLOP, 16.5 us, against 19 MB of x and g (5.6 us): bound by operations,
// as are the upsample's 64 -> 256 at 48x48 (10.9 GFLOP, 66 us) and at 96x96
// (43.5 GFLOP, 264 us). final_conv's 64 -> 3 at 192x192 is 2.0 GFLOP (12 us)
// against 158 MB of x and g (47 us): bound by its bytes, x read once.
//
// Tensor-core entry, `conv3x3_wgrad_f32_tc`: C % 16 == 0, F % 8 == 0 (the
// trunk and upsample shapes, 35 of a train step's 37). Split TF32 on
// mma.sync.m16n8k8: each operand v = hi + lo, hi = rna(v), lo = rna(v - hi),
// both rounded with cvt.rna on the card as they are loaded (x and g are
// activations; the tensor core reads a .tf32 register by dropping its low 13
// bits, so an unrounded operand would be truncated and lo would carry the
// wrong rest), and a x b taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, the
// small products first, f32 sums (conv3x3_bias_act.cu's scheme). M is the
// (tap, channel) rows, N the outputs, K the pixels. A block owns the 9 taps
// x a chunk of up to 64 channels (36 m16 tiles) x 64 outputs (8 n8 tiles)
// and walks its split's pixel tiles of 8 x 16. For each it stages, by
// 16-byte cp.async with zero fill outside the image, x's (8 + 2) x (16 + 2)
// halo (the SAME padding without a padded copy) and the tile's g beside it,
// once for all nine taps: a tap is a shifted view of the halo, so x comes
// from device memory (or L2) once per tile and output tile, never once per
// tap. Two stages: the next tile's copy is in flight while this tile's
// products run. Each tile's g is split once, by the block, into hi (in
// place) and lo (a third buffer), since every warp reads all of it; x is
// split as each warp loads it (a value of the halo feeds 9 taps, each the
// A fragment of one warp only). 12 warps, each 3 m16 tiles x 8 n8 tiles
// (96 f32 sums a lane); per k-step of 8 pixels (one half row of the tile)
// a warp loads and splits its 3 A fragments and, one n8 tile at a time,
// loads a split B fragment and runs the three products of each (m, n)
// tile. K is the pixel index, NHWC's strided dimension, so both fragments
// sit in shared memory as [k][m] and [k][n] and ldmatrix (which wants
// [m][k]) does not apply: each element is a plain 32-bit load,
// conflict-free at a pixel stride of 72 floats (== 8 mod 32: lane (g, t)
// reads t * 72 + g, 32 distinct banks). Shared memory: two stages of 180
// halo pixels + 128 g pixels, and the g tile's lo parts, at 72 floats,
// 214,272 bytes, one block an SM; 168 registers (the most 384 threads
// leave), 4 bytes spilled (ptxas -v). The upsample's 256 outputs are 4
// output tiles whose blocks sit next to each other in the grid, so x is
// re-read for each from L2. db is the column sums of the staged g tile on
// the CUDA cores, taken in the same pass that splits it (6 runs of pixels
// a column, added in order at the end), not a row of ones through the
// tensor cores (577 rows is not a multiple of 16). The tensor core's f32
// sums round toward zero, so the error grows with a split's length: the
// wrapper caps a split at 48 tiles (ops/conv3x3_wgrad.py MAX_TC_CHUNK).
//
// Narrow entry, `conv3x3_wgrad_f32_halo_narrow`: C % 16 == 0, F <= 4
// (final_conv). The same halo staging, at 8 x 32 pixel tiles and up to 64
// channels, in two stages (182,272 bytes, one block an SM), so x is read
// from device memory once (and its one-pixel rims, 1.33x, from L2). The
// products run on the CUDA cores with f32 sums: a thread owns one channel
// x the 9 taps x F outputs (9 F sums) and two rows of the tile, walks each
// row with a 3 x 3 window of x in registers (3 new shared-memory loads a
// pixel, the tile's g as one broadcast float4), and runs 9 F FMAs a pixel.
// Why not the tensor cores: F padded to mma's n = 8 and three products an
// f32 product make 8 / 3 x 3 = 8x the useful 2.0 GFLOP (16 GFLOP, ~50 us at
// mma.sync's TF32 rate, above the bytes' 47 us), while 2.0 GFLOP of f32 FMAs
// take 30 us at the CUDA cores' 67 TFLOP/s: below the bytes, so the copy
// bounds it either way, and FMAs need no split. The 4 row pairs' sums are
// added in order through shared memory at the end. 95 registers at F = 3
// (113 at F = 4), no spill.
//
// CUDA-core entries, `conv3x3_wgrad_f32` and `conv3x3_wgrad_f32_narrow`:
// the first design, kept for the shapes the others refuse (C % 16 != 0:
// first_conv's 3 -> 64) and as the earlier kernel of the same function. A
// block owns a BR x BF output tile and walks its chunk of pixels BK at a
// time: the BK x BR slice of A is gathered from x into shared memory
// (neighbouring threads on neighbouring channels of one pixel; the halo
// masked by the pixel's (h, w)), so every x value is fetched once per tap
// and once per F tile, and each thread keeps a TR x TF accumulator of f32
// FMAs. Two tile shapes: 64 x 64, and 256 x 4 for F <= 4.
//
// What holds them back (an H100 SXM at 700 W; the times are in PERF.md
// section 6, row 4). The tensor-core entry runs the upsample's 64 -> 256
// at ~3.2-3.6x its bound, level with cuDNN's f32 gradient at 96x96 and
// below it at 48x48, and the trunk's 64 -> 64 at ~5.6x, ~1.7x faster than
// cuDNN: its tf32 products run at about a third of the card's dense TF32
// rate of 495 TFLOP/s (3 x 43.5 GFLOP in 0.85 ms at 96x96 is 154 TFLOP/s),
// the rate conv3x3_bias_act.cu's split-TF32 kernel reaches too (mma.sync's
// TF32 rate, and three products an f32 product; wgmma, which takes tf32 only
// from K-major shared-memory tiles, would need the staged tiles
// transposed); the 96 accumulator registers a lane leave no room for
// more independent products (18 warps of 2 m16 tiles spilled and ran
// slower, chip_wgrad_variants.py); and the trunk's 288 pixel tiles keep
// 96 of the 132 SMs busy (3 tiles a block; 4 x 16 tiles took 8% off it and
// lost at 96x96, where the splits then ran in two waves). The
// narrow entry runs at ~3x its bytes bound: its cp.async copies into
// shared memory, one block an SM, and the halo's 1.33x rims from L2.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int BR, int BF, int BK, int TR, int TF>
__global__ void __launch_bounds__((BR / TR) * (BF / TF))
    wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         float* __restrict__ ws, int n, int h_img, int w_img, int c, int f,
                         int chunk) {
  constexpr int kThreads = (BR / TR) * (BF / TF);
  static_assert(kThreads % BR == 0, "each thread gathers one fixed row of A");
  static_assert((BK * BR) % kThreads == 0, "the A slice must split evenly");
  constexpr int kPixStep = kThreads / BR;
  constexpr int kPixPerThread = BK * BR / kThreads;

  __shared__ float a_s[BK][BR + 4];
  __shared__ float g_s[BK][BF + 4];
  // (h, w) of each pixel of the slice; -4 marks pixels past the chunk so
  // that every tap of them fails the bounds test below
  __shared__ int pix_h[BK];
  __shared__ int pix_w[BK];

  const int tid = threadIdx.x;
  const int rows = 9 * c + 1;
  const int m_total = n * h_img * w_img;
  const int r0 = blockIdx.x * BR;
  const int f0 = blockIdx.y * BF;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = m_total < p_begin + chunk ? m_total : p_begin + chunk;

  // this thread's row of A: a (tap, channel) of x, or the bias's ones
  const int r_col = tid % BR;
  const int pix0 = tid / BR;
  const int r = r0 + r_col;
  const bool r_x = r < rows - 1;
  const bool r_bias = r == rows - 1;
  const int tap = r_x ? r / c : 0;
  const int ch = r - tap * c;
  const int dy = tap / 3 - 1;
  const int dx = tap % 3 - 1;
  // element offset of the tap's neighbour relative to the pixel itself
  const long long shift = ((long long)dy * w_img + dx) * c + ch;

  const int tx = tid % (BF / TF);
  const int ty = tid / (BF / TF);
  float acc[TR][TF];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TF; ++j) acc[i][j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += BK) {
    for (int i = tid; i < BK; i += kThreads) {
      const int p = p0 + i;
      if (p < p_end) {
        pix_w[i] = p % w_img;
        pix_h[i] = (p / w_img) % h_img;
      } else {
        pix_h[i] = -4;
        pix_w[i] = -4;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) {
      const int kb = pix0 + i * kPixStep;
      const int hh = pix_h[kb] + dy;
      const int ww = pix_w[kb] + dx;
      float v = 0.f;
      if (pix_h[kb] >= 0) {
        if (r_bias)
          v = 1.f;
        else if (r_x && hh >= 0 && hh < h_img && ww >= 0 && ww < w_img)
          v = x[(long long)(p0 + kb) * c + shift];
      }
      a_s[kb][r_col] = v;
    }
    for (int e = tid; e < BK * BF; e += kThreads) {
      const int kb = e / BF;
      const int j = e % BF;
      const int p = p0 + kb;
      const int ff = f0 + j;
      g_s[kb][j] = (p < p_end && ff < f) ? g[(long long)p * f + ff] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BK; ++kb) {
      float a[TR];
      float b[TF];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = a_s[kb][ty * TR + i];
#pragma unroll
      for (int j = 0; j < TF; ++j) b[j] = g_s[kb][tx * TF + j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TF; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* part = ws + (long long)blockIdx.z * rows * f;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int rr = r0 + ty * TR + i;
    if (rr >= rows) continue;
#pragma unroll
    for (int j = 0; j < TF; ++j) {
      const int ff = f0 + tx * TF + j;
      if (ff < f) part[(long long)rr * f + ff] = acc[i][j];
    }
  }
}

// out[i] = the splits' partial sums of element i, added in split order
__global__ void __launch_bounds__(256)
    wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int size,
                        int splits) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(long long)z * size + i];
  out[i] = s;
}

template <int BR, int BF, int BK, int TR, int TF>
int wgrad(const void* x, const void* g, void* ws, void* out, int n, int h, int w_img, int c,
          int f, int splits, int chunk, void* stream) {
  const long long m_total = (long long)n * h * w_img;
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || f <= 0 || splits <= 0 || chunk <= 0 ||
      (long long)splits * chunk < m_total || (long long)(splits - 1) * chunk >= m_total ||
      m_total >= (1ll << 31) || 9ll * c + 1 >= (1ll << 31) / f)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = (BR / TR) * (BF / TF);
  const int rows = 9 * c + 1;
  const dim3 grid((unsigned)((rows + BR - 1) / BR), (unsigned)((f + BF - 1) / BF),
                  (unsigned)splits);
  wgrad_partial_kernel<BR, BF, BK, TR, TF><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(ws), n,
      h, w_img, c, f, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = rows * f;
  wgrad_reduce_kernel<<<dim3((unsigned)((size + 255) / 256)), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), size, splits);
  return (int)cudaGetLastError();
}

// ---- the tiled entries: x's halo staged once per pixel tile ----

struct WgShape {
  int n, h_img, w_img, c, f, h_tiles, w_tiles;
};

struct WgTile {
  long long img;
  int h0, w0;
};

// pixel tile t of TH x TW; tiles run along W, then H, then images
template <int TH, int TW>
__device__ __forceinline__ WgTile wg_tile(const WgShape& s, long long t) {
  const long long rest = t / s.w_tiles;
  return {rest / s.h_tiles, (int)(rest % s.h_tiles) * TH, (int)(t % s.w_tiles) * TW};
}

// a cp.async of `bytes` (4 or 16), or as many zero bytes if `zero`; a
// zero-filled copy reads nothing but still names a valid address
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool zero) {
  __pipeline_memcpy_async(dst, src, kBytes, zero ? kBytes : 0);
}

// x's halo of a TH x TW tile, (TH + 2) x (TW + 2) pixels from (h0 - 1, w0 -
// 1), channels c0 .. c0 + kc at a pixel stride of `ld` floats, zeros
// outside the image
template <int TH, int TW, int kThreads>
__device__ __forceinline__ void copy_x_halo(float* halo, int ld, const float* __restrict__ x,
                                            const WgShape& s, WgTile t, int c0, int kc) {
  constexpr int kW = TW + 2;
  const float* x_img = x + t.img * s.h_img * s.w_img * s.c;
  const int groups = kc / 4;
  for (int e = threadIdx.x; e < (TH + 2) * kW * groups; e += kThreads) {
    const int p = e / groups;
    const int q = e - p * groups;
    const int hh = t.h0 - 1 + p / kW;
    const int ww = t.w0 - 1 + p % kW;
    const bool inside = hh >= 0 && hh < s.h_img && ww >= 0 && ww < s.w_img;
    const float* src = inside ? x_img + ((long long)hh * s.w_img + ww) * s.c + c0 + 4 * q : x;
    cp_async<16>(halo + p * ld + 4 * q, src, !inside);
  }
}

// cvt.rna.tf32.f32: v rounded to 10 explicit mantissa bits, ties away from
// zero, low 13 bits zero
__device__ __forceinline__ unsigned tf32_rna(float v) {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
#elif !defined(__CUDACC__)
  return emu_cvt_rna_tf32(v);
#else
  return 0u;  // the host pass of nvcc compiles no device code
#endif
}

// v = hi + lo + O(2^-22 |v|), each part a tf32 value
__device__ __forceinline__ void split_tf32(unsigned& hi, unsigned& lo, float v) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a x b on one m16n8k8 tf32 product, f32 sums. Fragments (g = lane /
// 4, t = lane % 4): a[0] A(g, t), a[1] A(g + 8, t), a[2] A(g, t + 4), a[3]
// A(g + 8, t + 4); b0 B(t, g), b1 B(t + 4, g); d[2e + i] D(g + 8e, 2t + i)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#elif !defined(__CUDACC__)
  emu_mma_m16n8k8_tf32(d, a, b0, b1);
#endif
}

// tensor-core entry: 8 x 16 pixel tiles, 64 channels x 64 outputs a block
constexpr int kTcTH = 8;
constexpr int kTcTW = 16;
constexpr int kTcPix = kTcTH * kTcTW;
constexpr int kTcHW = kTcTW + 2;
constexpr int kTcHaloPix = (kTcTH + 2) * kTcHW;
constexpr int kTcKC = 64;  // channels of a block
constexpr int kTcBN = 64;  // outputs of a block
constexpr int kTcLd = 72;  // pixel stride of halo and g tile, floats: == 8 (mod 32)
constexpr int kTcWarps = 12;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMW = 3;             // m16 tiles of a warp: 12 x 3 = 9 taps x 64 / 16
constexpr int kTcNT = kTcBN / 8;     // n8 tiles of a warp
// two stages of (halo, g tile), then the g tile's lo parts
constexpr int kTcStage = (kTcHaloPix + kTcPix) * kTcLd;  // floats a stage
constexpr int kTcSmem = (2 * kTcStage + kTcPix * kTcLd) * 4;  // 214,272 bytes
constexpr int kTcDbRuns = kTcThreads / kTcBN;  // pixel runs of a g column
static_assert(kTcWarps * kTcMW * 16 == 9 * kTcKC, "the warps cover the 9 taps x 64 channels");
static_assert(kTcThreads % kTcBN == 0 && kTcDbRuns * kTcBN <= kTcStage, "g runs, db scratch");

// Block (f tile, channel chunk) = blockIdx.x, split blockIdx.z: pixel tiles
// [z chunk, min((z + 1) chunk, tiles)). Writes rows tap C + c0 .. + kc of
// the split's partial, outputs f0 .. f0 + live, and the db row from the
// blocks of channel chunk 0.
__global__ void __launch_bounds__(kTcThreads, 1)
    wgrad_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ ws, WgShape s, int chunk) {
  extern __shared__ __align__(128) float4 wg_tc_smem[];
  float* const smem = reinterpret_cast<float*>(wg_tc_smem);
  const int f_tiles = (s.f + kTcBN - 1) / kTcBN;
  const int f0 = (int)(blockIdx.x % f_tiles) * kTcBN;
  const int c0 = (int)(blockIdx.x / f_tiles) * kTcKC;
  const int kc = s.c - c0 < kTcKC ? s.c - c0 : kTcKC;
  const int live = s.f - f0 < kTcBN ? s.f - f0 : kTcBN;  // a multiple of 8
  const int nt = live / 8;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  const long long t_begin = (long long)blockIdx.z * chunk;
  const long long t_end = n_tiles < t_begin + chunk ? n_tiles : t_begin + chunk;
  const int rows = 9 * s.c + 1;

  const auto copy_tile = [&](long long tile, int stage) {
    float* const halo = smem + stage * kTcStage;
    float* const gt = halo + kTcHaloPix * kTcLd;
    const WgTile t = wg_tile<kTcTH, kTcTW>(s, tile);
    copy_x_halo<kTcTH, kTcTW, kTcThreads>(halo, kTcLd, x, s, t, c0, kc);
    const float* g_img = g + t.img * s.h_img * s.w_img * s.f;
    const int groups = live / 4;
    for (int e = threadIdx.x; e < kTcPix * groups; e += kTcThreads) {
      const int p = e / groups;
      const int q = e - p * groups;
      const int hh = t.h0 + p / kTcTW;
      const int ww = t.w0 + p % kTcTW;
      const bool inside = hh < s.h_img && ww < s.w_img;
      const float* src = inside ? g_img + ((long long)hh * s.w_img + ww) * s.f + f0 + 4 * q : g;
      cp_async<16>(gt + p * kTcLd + 4 * q, src, !inside);
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  // the warp's m16 tiles: tile mt = (tap, channels cc .. cc + 16) of the
  // chunk; a_off is the lane's a[0] element relative to the k-step's first
  // halo pixel, row_of its first output row
  const int cq = kc / 16;
  const int m_tiles = 9 * cq;
  bool m_live[kTcMW];
  int a_off[kTcMW], row_of[kTcMW];
#pragma unroll
  for (int i = 0; i < kTcMW; ++i) {
    const int mt = warp * kTcMW + i;
    m_live[i] = mt < m_tiles;
    const int tap = m_live[i] ? mt / cq : 0;
    const int cc = 16 * (mt - tap * cq);
    a_off[i] = ((tap / 3) * kTcHW + tap % 3 + tq) * kTcLd + cc + gq;
    row_of[i] = tap * s.c + c0 + cc + gq;
  }
  const int b_off = tq * kTcLd + gq;
  // the g values this thread splits and adds to db: column db_col of the
  // tile, pixels db_run, + kTcDbRuns, ...
  const int db_col = threadIdx.x % kTcBN;
  const int db_run = threadIdx.x / kTcBN;
  float db_acc = 0.f;

  float acc[kTcMW][kTcNT][4];
#pragma unroll
  for (int i = 0; i < kTcMW; ++i)
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  copy_tile(t_begin, 0);
  __pipeline_commit();
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int stage = (int)((tile - t_begin) % 2);
    if (tile + 1 < t_end) {
      copy_tile(tile + 1, stage ^ 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // this tile's halo and g have landed for every thread
    const float* const halo = smem + stage * kTcStage;
    float* const gt = smem + stage * kTcStage + kTcHaloPix * kTcLd;
    float* const g_lo = smem + 2 * kTcStage;
    // the g tile split once for all warps (each warp would split all of it
    // again): hi in place, lo beside; db takes the values unsplit
    if (db_col < live)
      for (int p = db_run; p < kTcPix; p += kTcDbRuns) {
        const float v = gt[p * kTcLd + db_col];
        if (c0 == 0) db_acc += v;
        unsigned hi, lo;
        split_tf32(hi, lo, v);
        gt[p * kTcLd + db_col] = __uint_as_float(hi);
        g_lo[p * kTcLd + db_col] = __uint_as_float(lo);
      }
    __syncthreads();
#pragma unroll 2
    for (int ks = 0; ks < kTcPix / 8; ++ks) {
      // k-step: pixels px0 .. px0 + 8 of tile row py
      const int py = ks / (kTcTW / 8);
      const int px0 = (ks % (kTcTW / 8)) * 8;
      const float* const hb = halo + (py * kTcHW + px0) * kTcLd;
      const float* const gb = gt + (py * kTcTW + px0) * kTcLd + b_off;
      const float* const gl = g_lo + (py * kTcTW + px0) * kTcLd + b_off;
      unsigned a_hi[kTcMW][4], a_lo[kTcMW][4];
#pragma unroll
      for (int i = 0; i < kTcMW; ++i) {
        if (!m_live[i]) continue;
        const float* const ap = hb + a_off[i];
        split_tf32(a_hi[i][0], a_lo[i][0], ap[0]);
        split_tf32(a_hi[i][1], a_lo[i][1], ap[8]);
        split_tf32(a_hi[i][2], a_lo[i][2], ap[4 * kTcLd]);
        split_tf32(a_hi[i][3], a_lo[i][3], ap[4 * kTcLd + 8]);
      }
#pragma unroll
      for (int j = 0; j < kTcNT; ++j) {
        if (j >= nt) continue;
        // B fragments (pixels t, t + 4; output g of n8 tile j), split
        const unsigned bh0 = __float_as_uint(gb[8 * j]), bh1 = __float_as_uint(gb[4 * kTcLd + 8 * j]);
        const unsigned bl0 = __float_as_uint(gl[8 * j]), bl1 = __float_as_uint(gl[4 * kTcLd + 8 * j]);
#pragma unroll
        for (int i = 0; i < kTcMW; ++i)
          if (m_live[i]) mma_tf32(acc[i][j], a_lo[i], bh0, bh1);
#pragma unroll
        for (int i = 0; i < kTcMW; ++i)
          if (m_live[i]) mma_tf32(acc[i][j], a_hi[i], bl0, bl1);
#pragma unroll
        for (int i = 0; i < kTcMW; ++i)
          if (m_live[i]) mma_tf32(acc[i][j], a_hi[i], bh0, bh1);
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  float* const part = ws + (long long)blockIdx.z * rows * s.f;
#pragma unroll
  for (int i = 0; i < kTcMW; ++i) {
    if (!m_live[i]) continue;
#pragma unroll
    for (int j = 0; j < kTcNT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(part + (long long)(row_of[i] + 8 * e) * s.f + f0 + 8 * j +
                                   2 * tq) = make_float2(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
    }
  }
  if (c0 == 0) {
    smem[db_run * kTcBN + db_col] = db_acc;
    __syncthreads();
    if ((int)threadIdx.x < live) {
      float sum = 0.f;
      for (int r = 0; r < kTcDbRuns; ++r) sum += smem[r * kTcBN + threadIdx.x];
      part[(long long)(rows - 1) * s.f + f0 + threadIdx.x] = sum;
    }
  }
}

// d += a x b on one m16n8k16 bf16 product, f32 sums. Fragments (g = lane /
// 4, t = lane % 4), each register two bf16 of consecutive k, the lower k in
// the low half: a[0] A(g, 2t), a[1] A(g + 8, 2t), a[2] A(g, 2t + 8), a[3]
// A(g + 8, 2t + 8); b0 B(2t, g), b1 B(2t + 8, g); d as mma_tf32's
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#elif !defined(__CUDACC__)
  emu_mma_m16n8k16(d, a, b0, b1);
#endif
}

// two bf16 (their bit patterns), lo in the low half
__device__ __forceinline__ unsigned pack_bf16x2(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// bf16 tensor-core entry: the f32 entry's tiles, blocks and splits, with x's
// halo and the g tile staged as bf16 (16-byte cp.async of 8 values) and one
// m16n8k16 bf16 product where the f32 entry runs three tf32 ones
constexpr int kBfLd = 72;  // pixel stride of halo and g tile, bf16 values: 36 words
constexpr int kBfStage = (kTcHaloPix + kTcPix) * kBfLd;  // values a stage
constexpr int kBfSmem = 2 * kBfStage * 2;                // 88,704 bytes
static_assert(kTcTW == 16, "a k16 step is one tile row");
static_assert(kTcDbRuns * kTcBN * 4 <= kBfStage * 2, "db scratch");

// x's halo as wg's copy_x_halo, in bf16: 8 channels a 16-byte copy
template <int TH, int TW, int kThreads>
__device__ __forceinline__ void copy_x_halo_bf16(unsigned short* halo, int ld,
                                                 const unsigned short* __restrict__ x,
                                                 const WgShape& s, WgTile t, int c0, int kc) {
  constexpr int kW = TW + 2;
  const unsigned short* x_img = x + t.img * s.h_img * s.w_img * s.c;
  const int groups = kc / 8;
  for (int e = threadIdx.x; e < (TH + 2) * kW * groups; e += kThreads) {
    const int p = e / groups;
    const int q = e - p * groups;
    const int hh = t.h0 - 1 + p / kW;
    const int ww = t.w0 - 1 + p % kW;
    const bool inside = hh >= 0 && hh < s.h_img && ww >= 0 && ww < s.w_img;
    const unsigned short* src =
        inside ? x_img + ((long long)hh * s.w_img + ww) * s.c + c0 + 8 * q : x;
    cp_async<16>(halo + p * ld + 8 * q, src, !inside);
  }
}

// As wgrad_tc_kernel, on bf16 x and g (their bit patterns): block (f tile,
// channel chunk) = blockIdx.x, split blockIdx.z; a k-step is the 16 pixels
// of one tile row; f32 sums, db from the staged g values in f32.
__global__ void __launch_bounds__(kTcThreads, 1)
    wgrad_tc_bf16_kernel(const unsigned short* __restrict__ x,
                         const unsigned short* __restrict__ g, float* __restrict__ ws,
                         WgShape s, int chunk) {
  extern __shared__ __align__(128) float4 wg_bf_smem[];
  unsigned short* const smem = reinterpret_cast<unsigned short*>(wg_bf_smem);
  const int f_tiles = (s.f + kTcBN - 1) / kTcBN;
  const int f0 = (int)(blockIdx.x % f_tiles) * kTcBN;
  const int c0 = (int)(blockIdx.x / f_tiles) * kTcKC;
  const int kc = s.c - c0 < kTcKC ? s.c - c0 : kTcKC;
  const int live = s.f - f0 < kTcBN ? s.f - f0 : kTcBN;  // a multiple of 8
  const int nt = live / 8;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  const long long t_begin = (long long)blockIdx.z * chunk;
  const long long t_end = n_tiles < t_begin + chunk ? n_tiles : t_begin + chunk;
  const int rows = 9 * s.c + 1;

  const auto copy_tile = [&](long long tile, int stage) {
    unsigned short* const halo = smem + stage * kBfStage;
    unsigned short* const gt = halo + kTcHaloPix * kBfLd;
    const WgTile t = wg_tile<kTcTH, kTcTW>(s, tile);
    copy_x_halo_bf16<kTcTH, kTcTW, kTcThreads>(halo, kBfLd, x, s, t, c0, kc);
    const unsigned short* g_img = g + t.img * s.h_img * s.w_img * s.f;
    const int groups = live / 8;
    for (int e = threadIdx.x; e < kTcPix * groups; e += kTcThreads) {
      const int p = e / groups;
      const int q = e - p * groups;
      const int hh = t.h0 + p / kTcTW;
      const int ww = t.w0 + p % kTcTW;
      const bool inside = hh < s.h_img && ww < s.w_img;
      const unsigned short* src =
          inside ? g_img + ((long long)hh * s.w_img + ww) * s.f + f0 + 8 * q : g;
      cp_async<16>(gt + p * kBfLd + 8 * q, src, !inside);
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  // the warp's m16 tiles as in wgrad_tc_kernel; a_off is the lane's a[0]
  // element (channel cc + g, pixel 2t) relative to the k-step's first halo
  // pixel
  const int cq = kc / 16;
  const int m_tiles = 9 * cq;
  bool m_live[kTcMW];
  int a_off[kTcMW], row_of[kTcMW];
#pragma unroll
  for (int i = 0; i < kTcMW; ++i) {
    const int mt = warp * kTcMW + i;
    m_live[i] = mt < m_tiles;
    const int tap = m_live[i] ? mt / cq : 0;
    const int cc = 16 * (mt - tap * cq);
    a_off[i] = ((tap / 3) * kTcHW + tap % 3 + 2 * tq) * kBfLd + cc + gq;
    row_of[i] = tap * s.c + c0 + cc + gq;
  }
  const int b_off = 2 * tq * kBfLd + gq;
  const int db_col = threadIdx.x % kTcBN;
  const int db_run = threadIdx.x / kTcBN;
  float db_acc = 0.f;

  float acc[kTcMW][kTcNT][4];
#pragma unroll
  for (int i = 0; i < kTcMW; ++i)
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  copy_tile(t_begin, 0);
  __pipeline_commit();
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int stage = (int)((tile - t_begin) % 2);
    if (tile + 1 < t_end) {
      copy_tile(tile + 1, stage ^ 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // this tile's halo and g have landed for every thread
    const unsigned short* const halo = smem + stage * kBfStage;
    const unsigned short* const gt = halo + kTcHaloPix * kBfLd;
    if (c0 == 0 && db_col < live)
      for (int p = db_run; p < kTcPix; p += kTcDbRuns)
        db_acc += __uint_as_float((unsigned)gt[p * kBfLd + db_col] << 16);
#pragma unroll 2
    for (int py = 0; py < kTcTH; ++py) {
      // k-step: the 16 pixels of tile row py
      const unsigned short* const hb = halo + py * kTcHW * kBfLd;
      const unsigned short* const gb = gt + py * kTcTW * kBfLd + b_off;
      unsigned a[kTcMW][4];
#pragma unroll
      for (int i = 0; i < kTcMW; ++i) {
        if (!m_live[i]) continue;
        const unsigned short* const ap = hb + a_off[i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const unsigned short* const q = ap + (r / 2) * 8 * kBfLd + (r % 2) * 8;
          a[i][r] = pack_bf16x2(q[0], q[kBfLd]);
        }
      }
#pragma unroll
      for (int j = 0; j < kTcNT; ++j) {
        if (j >= nt) continue;
        const unsigned short* const bq = gb + 8 * j;
        const unsigned b0 = pack_bf16x2(bq[0], bq[kBfLd]);
        const unsigned b1 = pack_bf16x2(bq[8 * kBfLd], bq[9 * kBfLd]);
#pragma unroll
        for (int i = 0; i < kTcMW; ++i)
          if (m_live[i]) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  float* const part = ws + (long long)blockIdx.z * rows * s.f;
#pragma unroll
  for (int i = 0; i < kTcMW; ++i) {
    if (!m_live[i]) continue;
#pragma unroll
    for (int j = 0; j < kTcNT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(part + (long long)(row_of[i] + 8 * e) * s.f + f0 + 8 * j +
                                   2 * tq) = make_float2(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
    }
  }
  if (c0 == 0) {
    float* const scratch = reinterpret_cast<float*>(wg_bf_smem);
    scratch[db_run * kTcBN + db_col] = db_acc;
    __syncthreads();
    if ((int)threadIdx.x < live) {
      float sum = 0.f;
      for (int r = 0; r < kTcDbRuns; ++r) sum += scratch[r * kTcBN + threadIdx.x];
      part[(long long)(rows - 1) * s.f + f0 + threadIdx.x] = sum;
    }
  }
}

// narrow entry: 8 x 32 pixel tiles, 64 channels a block, F <= 4 outputs
constexpr int kNwTH = 8;
constexpr int kNwTW = 32;
constexpr int kNwPix = kNwTH * kNwTW;
constexpr int kNwHW = kNwTW + 2;
constexpr int kNwHaloPix = (kNwTH + 2) * kNwHW;
constexpr int kNwKC = 64;                  // channels of a block = the halo's pixel stride
constexpr int kNwRowPairs = kNwTH / 2;     // a thread's two tile rows
constexpr int kNwThreads = kNwKC * kNwRowPairs;
constexpr int kNwStage = kNwHaloPix * kNwKC + kNwPix * 4;  // halo, then g padded to 4
constexpr int kNwSmem = 2 * kNwStage * 4;                   // 182,272 bytes
constexpr int kNwDbRuns = kNwThreads / 4;                   // pixel runs of a db column
static_assert(kNwRowPairs * 9 * kNwKC * 4 + kNwDbRuns * 4 <= kNwStage, "epilogue scratch");

// Block = channel chunk blockIdx.x, split blockIdx.z. Thread (channel ch =
// tid % 64, row pair rp = tid / 64) sums x_pad * g over tile rows 2 rp, 2 rp
// + 1 for its channel's 9 taps and the FP outputs.
template <int FP>
__global__ void __launch_bounds__(kNwThreads, 1)
    wgrad_narrow_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        float* __restrict__ ws, WgShape s, int chunk) {
  extern __shared__ __align__(128) float4 wg_nw_smem[];
  float* const smem = reinterpret_cast<float*>(wg_nw_smem);
  const int c0 = (int)blockIdx.x * kNwKC;
  const int kc = s.c - c0 < kNwKC ? s.c - c0 : kNwKC;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  const long long t_begin = (long long)blockIdx.z * chunk;
  const long long t_end = n_tiles < t_begin + chunk ? n_tiles : t_begin + chunk;
  const int rows = 9 * s.c + 1;

  const auto copy_tile = [&](long long tile, int stage) {
    float* const halo = smem + stage * kNwStage;
    float* const gt = halo + kNwHaloPix * kNwKC;
    const WgTile t = wg_tile<kNwTH, kNwTW>(s, tile);
    copy_x_halo<kNwTH, kNwTW, kNwThreads>(halo, kNwKC, x, s, t, c0, kc);
    const float* g_img = g + t.img * s.h_img * s.w_img * s.f;
    for (int e = threadIdx.x; e < kNwPix * 4; e += kNwThreads) {
      const int p = e / 4;
      const int q = e % 4;
      const int hh = t.h0 + p / kNwTW;
      const int ww = t.w0 + p % kNwTW;
      const bool inside = q < FP && hh < s.h_img && ww < s.w_img;
      const float* src = inside ? g_img + ((long long)hh * s.w_img + ww) * FP + q : g;
      cp_async<4>(gt + e, src, !inside);
    }
  };

  const int ch = threadIdx.x % kNwKC;
  const int rp = threadIdx.x / kNwKC;
  const int db_col = threadIdx.x % 4;
  const int db_run = threadIdx.x / 4;
  float db_acc = 0.f;
  float acc[9][FP];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int f = 0; f < FP; ++f) acc[k][f] = 0.f;

  copy_tile(t_begin, 0);
  __pipeline_commit();
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int stage = (int)((tile - t_begin) % 2);
    if (tile + 1 < t_end) {
      copy_tile(tile + 1, stage ^ 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // this tile's halo and g have landed for every thread
    const float* const halo = smem + stage * kNwStage;
    const float* const gt = halo + kNwHaloPix * kNwKC;
    if (ch < kc) {
#pragma unroll 1
      for (int r = 0; r < 2; ++r) {
        const int py = 2 * rp + r;
        const float* const hb = halo + py * kNwHW * kNwKC + ch;
        const float* const gr = gt + py * kNwTW * 4;
        // win[dy][dx]: x at halo (py + dy, px + dx), slid along the row
        float win[3][3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[dy][0] = hb[(dy * kNwHW) * kNwKC];
          win[dy][1] = hb[(dy * kNwHW + 1) * kNwKC];
        }
#pragma unroll 4
        for (int px = 0; px < kNwTW; ++px) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) win[dy][2] = hb[(dy * kNwHW + px + 2) * kNwKC];
          const float4 gv = *reinterpret_cast<const float4*>(gr + 4 * px);
          const float gf[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int k = 0; k < 9; ++k)
#pragma unroll
            for (int f = 0; f < FP; ++f) acc[k][f] = fmaf(win[k / 3][k % 3], gf[f], acc[k][f]);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            win[dy][0] = win[dy][1];
            win[dy][1] = win[dy][2];
          }
        }
      }
    }
    if (c0 == 0 && db_col < FP)
      for (int p = db_run; p < kNwPix; p += kNwDbRuns) db_acc += gt[4 * p + db_col];
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // the row pairs' sums, then the db runs', added in order
  float* const red = smem;  // [row pair][tap][channel][FP]
  float* const db_red = smem + kNwRowPairs * 9 * kNwKC * 4;
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int f = 0; f < FP; ++f) red[((rp * 9 + k) * kNwKC + ch) * FP + f] = acc[k][f];
  db_red[threadIdx.x] = db_acc;
  __syncthreads();
  float* const part = ws + (long long)blockIdx.z * rows * s.f;
  for (int e = threadIdx.x; e < 9 * kc * FP; e += kNwThreads) {
    const int k = e / (kc * FP);
    const int rest = e - k * kc * FP;
    const int c = rest / FP;
    const int f = rest - c * FP;
    float sum = 0.f;
    for (int r = 0; r < kNwRowPairs; ++r) sum += red[((r * 9 + k) * kNwKC + c) * FP + f];
    part[(long long)(k * s.c + c0 + c) * FP + f] = sum;
  }
  if (c0 == 0 && (int)threadIdx.x < FP) {
    float sum = 0.f;
    for (int r = 0; r < kNwDbRuns; ++r) sum += db_red[4 * r + threadIdx.x];
    part[(long long)(rows - 1) * FP + threadIdx.x] = sum;
  }
}

// what both tiled entries take: C % 16 == 0; x, g and ws 16-byte aligned;
// `splits` runs of `chunk` pixel tiles of TH x TW that cover every tile, none
// empty
template <int TH, int TW>
int tiled_refusal(const void* x, const void* g, const void* ws, int n, int h, int w_img, int c,
                  int f, int splits, int chunk, WgShape* s) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || f <= 0 || c % 16 || splits <= 0 ||
      chunk <= 0 || splits > 65535 || 9ll * c + 1 >= (1ll << 31) / f ||
      (long long)n * h * w_img >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(g) |
       reinterpret_cast<std::uintptr_t>(ws)) % 16)
    return (int)cudaErrorInvalidValue;
  *s = WgShape{n, h, w_img, c, f, (h + TH - 1) / TH, (w_img + TW - 1) / TW};
  const long long tiles = (long long)n * s->h_tiles * s->w_tiles;
  if ((long long)splits * chunk < tiles || (long long)(splits - 1) * chunk >= tiles)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// the second pass over a tiled entry's partials
int reduce_splits(const void* ws, void* out, const WgShape& s, int splits, void* stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = (9 * s.c + 1) * s.f;
  wgrad_reduce_kernel<<<dim3((unsigned)((size + 255) / 256)), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), size, splits);
  return (int)cudaGetLastError();
}

int wgrad_tc(const void* x, const void* g, void* ws, void* out, int n, int h, int w_img, int c,
             int f, int splits, int chunk, void* stream) {
  WgShape s;
  const int refused =
      tiled_refusal<kTcTH, kTcTW>(x, g, ws, n, h, w_img, c, f, splits, chunk, &s);
  if (refused) return refused;
  if (f % 8) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = ((f + kTcBN - 1) / kTcBN) * ((c + kTcKC - 1) / kTcKC);
  wgrad_tc_kernel<<<dim3((unsigned)blocks, 1, (unsigned)splits), kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(ws), s,
      chunk);
  return reduce_splits(ws, out, s, splits, stream);
}

int wgrad_tc_bf16(const void* x, const void* g, void* ws, void* out, int n, int h,
                  int w_img, int c, int f, int splits, int chunk, void* stream) {
  WgShape s;
  const int refused =
      tiled_refusal<kTcTH, kTcTW>(x, g, ws, n, h, w_img, c, f, splits, chunk, &s);
  if (refused) return refused;
  if (f % 8) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_tc_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBfSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = ((f + kTcBN - 1) / kTcBN) * ((c + kTcKC - 1) / kTcKC);
  wgrad_tc_bf16_kernel<<<dim3((unsigned)blocks, 1, (unsigned)splits), kTcThreads, kBfSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(g),
      static_cast<float*>(ws), s, chunk);
  return reduce_splits(ws, out, s, splits, stream);
}

template <int FP>
int wgrad_narrow_launch(const void* x, const void* g, void* ws, const WgShape& s, int splits,
                        int chunk, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_narrow_kernel<FP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kNwSmem);
  if (attr != cudaSuccess) return (int)attr;
  wgrad_narrow_kernel<FP><<<dim3((unsigned)((s.c + kNwKC - 1) / kNwKC), 1, (unsigned)splits), kNwThreads, kNwSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(ws), s,
      chunk);
  return (int)cudaSuccess;
}

int wgrad_halo_narrow(const void* x, const void* g, void* ws, void* out, int n, int h,
                      int w_img, int c, int f, int splits, int chunk, void* stream) {
  WgShape s;
  const int refused =
      tiled_refusal<kNwTH, kNwTW>(x, g, ws, n, h, w_img, c, f, splits, chunk, &s);
  if (refused) return refused;
  int err = (int)cudaErrorInvalidValue;
  switch (f) {
    case 1: err = wgrad_narrow_launch<1>(x, g, ws, s, splits, chunk, stream); break;
    case 2: err = wgrad_narrow_launch<2>(x, g, ws, s, splits, chunk, stream); break;
    case 3: err = wgrad_narrow_launch<3>(x, g, ws, s, splits, chunk, stream); break;
    case 4: err = wgrad_narrow_launch<4>(x, g, ws, s, splits, chunk, stream); break;
  }
  if (err) return err;
  return reduce_splits(ws, out, s, splits, stream);
}

}  // namespace

// Plain C entry points for ctypes. x: (n, h, w, c) f32 contiguous; g: (n, h,
// w, f) f32 contiguous; ws: (splits, 9c + 1, f) f32 scratch; out: (9c + 1,
// f) f32, dW as the HWIO kernel reshaped to (9c, f), then db. Split z sums
// pixels [z * chunk, min((z + 1) * chunk, n h w)); every split must hold a
// pixel. The launches go on `stream` and do not synchronise; the return
// value is cudaGetLastError() after each launch (0 = both launched), and
// cudaErrorInvalidValue with nothing launched for a shape or split it
// does not take.
extern "C" int conv3x3_wgrad_f32(const void* x, const void* g, void* ws, void* out, int n, int h,
                                 int w_img, int c, int f, int splits, int chunk, void* stream) {
  return wgrad<64, 64, 16, 4, 4>(x, g, ws, out, n, h, w_img, c, f, splits, chunk, stream);
}

// F <= 4 (final_conv's 64 -> 3): 256 x 4 output tiles.
extern "C" int conv3x3_wgrad_f32_narrow(const void* x, const void* g, void* ws, void* out, int n,
                                        int h, int w_img, int c, int f, int splits, int chunk,
                                        void* stream) {
  if (f > 4) return (int)cudaErrorInvalidValue;
  return wgrad<256, 4, 16, 1, 4>(x, g, ws, out, n, h, w_img, c, f, splits, chunk, stream);
}

// The tiled entries: the same arguments and output, with the pixel sum cut
// into pixel tiles (8 x 16 for the tensor-core entry, 8 x 32 for the narrow
// one; tiles run along W, then H, then images): split z sums tiles [z *
// chunk, min((z + 1) * chunk, tiles)), and every split must hold a tile.
// Both take C % 16 == 0 and x, g and ws 16-byte aligned; the tensor-core
// entry F % 8 == 0, the narrow one F <= 4. Anything else: cudaErrorInvalidValue
// with nothing launched.
extern "C" int conv3x3_wgrad_f32_tc(const void* x, const void* g, void* ws, void* out, int n,
                                    int h, int w_img, int c, int f, int splits, int chunk,
                                    void* stream) {
  return wgrad_tc(x, g, ws, out, n, h, w_img, c, f, splits, chunk, stream);
}

extern "C" int conv3x3_wgrad_f32_halo_narrow(const void* x, const void* g, void* ws, void* out,
                                             int n, int h, int w_img, int c, int f, int splits,
                                             int chunk, void* stream) {
  return wgrad_halo_narrow(x, g, ws, out, n, h, w_img, c, f, splits, chunk, stream);
}

// The bf16 tensor-core entry: x and g bf16 (n, h, w, c) / (n, h, w, f),
// contiguous, 16-byte aligned; the same pixel tiles, splits, workspace and
// f32 output as conv3x3_wgrad_f32_tc, C % 16 == 0 and F % 8 == 0. Every
// product of two bf16 values is exact in f32; the sums are f32.
extern "C" int conv3x3_wgrad_bf16_tc(const void* x, const void* g, void* ws, void* out, int n,
                                     int h, int w_img, int c, int f, int splits, int chunk,
                                     void* stream) {
  return wgrad_tc_bf16(x, g, ws, out, n, h, w_img, c, f, splits, chunk, stream);
}
