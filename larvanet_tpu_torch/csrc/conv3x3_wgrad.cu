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
// 192x192 (out 577 x 3), so a grid over the output alone has 10 or 3 blocks.
// K is therefore split across blocks (gridDim.z splits of `chunk` pixels,
// chosen by the wrapper for the card's SM count, ops/conv3x3_wgrad.py
// `splits_for`), each writing its partial sums to a workspace, and a second
// kernel adds the partials in split order. No float atomics: the result is
// the same bit for bit on every run, which a resumed training run needs to
// repeat an uninterrupted one.
//
// A first version, right and simple: the CUDA cores with f32 sums. A block
// owns a BR x BF output tile and walks its chunk of pixels BK at a time: the BK x BR slice of A is gathered from x into shared
// memory (neighbouring threads on neighbouring channels of one pixel,
// contiguous in NHWC; the halo masked by the pixel's (h, w)), the BK x BF
// slice of g beside it, and each thread keeps a TR x TF accumulator in
// registers. Two tile shapes: 64 x 64 for wide outputs and 256 x 4 for
// F <= 4 (final_conv), so that 64 -> 3 does not run 61 idle columns. Bound on
// an H100 SXM: at 16 x 48x48 a 64 -> 64 trunk conv's gradient is 2.7 GFLOP
// and 19 MB, 16 us at the split-TF32 tensor rate of 165 TFLOP/s; the kernel
// runs the f32 FMAs on the CUDA cores (67 TFLOP/s peak), gathers each x
// value once per tap (from L2 after the first), and loads 8 shared-memory
// values per 16 FMAs (5 per 4 in the narrow tile). Next: split TF32 on
// mma.sync or wgmma, with x staged once per pixel block for all nine taps.

#include <cuda_runtime.h>

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
