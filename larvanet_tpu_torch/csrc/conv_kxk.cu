// KxK convolution with explicit zero pads, NHWC x HWIO, stride 1, and its
// weight gradient, for Hopper.
//
// Replaces no TPU kernel. The JAX package computes these convolutions with
// XLA (jax.lax.conv_general_dilated in larvanet_tpu/ops/collapsed_tail.py
// `apply_collapsed_tail`, :324-332 and :361-365) and their gradients with
// jax.grad: EDSR's collapsed linear tail, which folds the upsample chain
// (conv 64 -> 256, PixelShuffle, conv 64 -> 256, PixelShuffle, conv 64 -> 3,
// inverse mean shift) into one 5x5 conv to 3 s^2 channels and one shuffle.
// In the port every conv of the tail's route runs here: the main 5x5 SAME
// conv (64 -> 12, 27 or 48 at x2, x3, x4), the probed border operators
// ((4, 5) with pads (0, 0, 2, 2) and (5, 4) with pads (2, 2, 0, 0), 64 ->
// 24, 54 or 96, on 4-pixel strips), the input gradient of the live training
// tail (the same conv on the kernel rotated by 180 degrees, 48 -> 64) and
// the collapsed interpolated base (3 -> 3 s^2). conv3x3_bias_act.cu takes
// 3x3 only.
//
//   y[n, i, j, f] = bias[f] + sum over ky, kx, c of
//                   x[n, i + ky - pt, j + kx - pl, c] * w[ky, kx, c, f]
//
// with x zero outside the image; the output is (H + pt + pb - kh + 1) x
// (W + pl + pr - kw + 1). Sums in f32, the result stored in x's dtype.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense tensor, f32-accurate
// products at 495 / 3 = 165 TFLOP/s in split TF32, 3.35 TB/s): the main
// conv of EDSR-baseline x4 at 4 x 192x192 LR is 22.6 GFLOP against 18.9 MB
// of x and 14.2 MB of y in bf16: 22.9 us of products, 9.9 us of bytes. It is
// bound by its operations in both dtypes (f32: 137 us), so the products run
// on the tensor cores.
//
// Tensor-core entries, `conv_kxk_bf16_tc` and `conv_kxk_f32_tc` (C a
// multiple of 16): an implicit GEMM on mma.sync, M = output pixels, N =
// outputs, K = taps x C. A block owns a tile of 8 x 16 output pixels and BN
// = 8 NT outputs (NT n8 tiles, the smallest instance that covers F up to
// 64, so 12, 27, 24, 54 and 48 outputs waste at most one n8 tile; larger F
// takes several blocks of 64); each of its 8 warps one output row of 16
// pixels (one m16 tile) x BN. The channels go in chunks of 32 bytes a
// pixel (16 bf16 or 8 f32 values: one k-step of m16n8k16 bf16 or m16n8k8
// tf32 a tap). Per chunk the block stages the input halo ((8 + kh - 1) x
// (16 + kw - 1) pixels, zeros outside the image: the pads without a padded
// copy of x) and every tap's weights for its BN outputs, then each warp runs
// all taps with no barrier: its A operand of a tap is a shifted view of the
// halo. Halo pixels sit 48 bytes apart (32 bytes of data) and weight rows
// 32 bytes apart with the halves of every other group of four swapped, so
// the lanes of a fragment load (row g, word t) fall in 32 distinct banks. f32
// runs in split TF32: each operand v = hi + lo, hi = rna(v), lo = rna(v -
// hi), a x b taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (conv3x3_bias_act.cu's
// scheme); the weights are split as they are staged, the activations as a
// warp loads them. A pixel's sum runs over chunks, then taps, then the k-step
// in the same order wherever the pixel lies in its tile and whatever the
// batch, so two calls give it the same bits (the probes of the collapsed
// tail subtract responses and need exact cancellation). The wrapper hands
// the weight as [kh kw][F][C] (ops/conv_kxk.py `entry_weight`), so a
// weight row's channels are contiguous.
//
// CUDA-core entries, `conv_kxk_f32` and `conv_kxk_bf16` (any C: the 3-channel
// base, the tests' narrow widths, the input gradient at x2 and x3): one
// thread an output value, taps then channels in order, f32 FMAs. Every
// forward entry takes the weight as [kh kw][F][C].
//
// Weight gradient, `conv_kxk_wgrad_f32` and `conv_kxk_wgrad_bf16` (x and g
// in one dtype, f32 sums): for the gradient g of the conv's output before
// its bias,
//
//   dW[ky, kx, c, f] = sum over n, i, j of x[n, i + ky - pt, j + kx - pl, c] * g[n, i, j, f]
//   db[f]            = sum over n, i, j of g[n, i, j, f]
//
// as out = A^T g with the virtual im2col rows of x (kh kw C values a
// pixel, tap-major, then a one for db) and K = the output pixels. For the
// live tail's 5x5 64 -> 48 at batch 16 x 48x48 that is 36,864 pixels into
// 1,601 x 48 sums (5.7 GFLOP in f32, 85 us on the CUDA cores' 67 TFLOP/s;
// 16.5 MB of x and g, 4.9 us). The pixel sum is cut into `splits` runs (chosen by
// the wrapper for the card's SM count), each block sums its run for a tile
// of 64 rows x 64 outputs on the CUDA cores (16 pixels a step, 4 x 4 sums a
// thread) into a workspace, and a second kernel adds the runs in order: no
// float atomics, the same bits on every run (a resumed training run repeats
// an uninterrupted one).
//
// What holds it back (a first design, right before fast): the staging is
// synchronous, with a barrier a chunk; every block re-stages the weights of
// its chunk (from L2); the fragments are plain 32-bit shared loads, not
// ldmatrix; mma.sync is not wgmma; the wgrad runs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int n, h, w, c;  // the input
  int kh, kw, f;   // the kernel
  int pt, pl;      // the top and left pads
  int ho, wo;      // the output
};

// ---- CUDA-core forward (any C) ----

constexpr int kCcThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCcThreads)
    conv_kxk_cc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y, Shape s) {
  const long long total = (long long)s.n * s.ho * s.wo * s.f;
  const long long i = (long long)blockIdx.x * kCcThreads + threadIdx.x;
  if (i >= total) return;
  const int f = (int)(i % s.f);
  long long p = i / s.f;
  const int ow = (int)(p % s.wo);
  p /= s.wo;
  const int oh = (int)(p % s.ho);
  const long long img = p / s.ho;
  float acc = 0.f;
  for (int ky = 0; ky < s.kh; ++ky) {
    const int ih = oh + ky - s.pt;
    if (ih < 0 || ih >= s.h) continue;
    for (int kx = 0; kx < s.kw; ++kx) {
      const int iw = ow + kx - s.pl;
      if (iw < 0 || iw >= s.w) continue;
      const T* xp = x + ((img * s.h + ih) * s.w + iw) * s.c;
      const T* wp = w + ((long long)(ky * s.kw + kx) * s.f + f) * s.c;
      for (int c = 0; c < s.c; ++c) acc = fmaf(to_f32(xp[c]), to_f32(wp[c]), acc);
    }
  }
  y[i] = from_f32<T>(acc + bias[f]);
}

// ---- tensor-core forward (C % 16 == 0) ----

constexpr int kTH = 8;        // output rows of a tile: one a warp
constexpr int kTW = 16;       // output columns of a tile: one m16 tile
constexpr int kWarps = kTH;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kWords = 8;     // 32-bit words of a chunk a pixel (or a weight row)
constexpr int kLd = 12;       // words between halo pixels in shared memory (bank spread)
constexpr int kMaxNT = 8;     // n8 tiles of a block: 64 outputs

__device__ __forceinline__ unsigned tf32_rna(float v) {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
#elif !defined(__CUDACC__)
  return emu_cvt_rna_tf32(v);  // the CPU stand-in (ops/emulate.py)
#else
  return 0u;  // the host pass of nvcc compiles no device code
#endif
}

// v = hi + lo + O(2^-22 |v|), each part a tf32 value
__device__ __forceinline__ void split_tf32(unsigned& hi, unsigned& lo, unsigned v) {
  const float f = __uint_as_float(v);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

// d += a x b on one m16n8k8 tf32 product, f32 sums
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

// d += a x b on one m16n8k16 bf16 product, f32 sums
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

__host__ __device__ constexpr int halo_pixels(int kh, int kw) {
  return (kTH + kh - 1) * (kTW + kw - 1);
}

// shared memory in words: the halo, the weights of every tap for BN outputs
// (f32: hi and lo; kWords a row, the two halves of a row swapped on rows 4..7
// of each 8 so that the lanes of a B fragment load fall in distinct banks),
// the bias
__host__ __device__ constexpr int tc_smem_words(bool f32, int kh, int kw, int nt) {
  return halo_pixels(kh, kw) * kLd + (f32 ? 2 : 1) * kh * kw * 8 * nt * kWords + 8 * nt;
}

// Block (tile, output group): tile blockIdx.x runs along W, then H, then
// images; outputs f0 = blockIdx.y * 8 NT. Warp r owns output row r of the
// tile; lane (g, t) = (lane / 4, lane % 4) as in the PTX fragment layouts:
// A(row m, k) is pixel m of the row, B(k, n) output n, and a chunk's 32
// bytes a pixel are 8 words, word k of f32 the channel k, word k of bf16
// the channels 2k and 2k + 1.
template <typename T, int NT>
__global__ void __launch_bounds__(kTcThreads)
    conv_kxk_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y, Shape s) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kBN = 8 * NT;
  constexpr int kCh = kF32 ? 8 : 16;  // channels of a chunk
  extern __shared__ __align__(16) unsigned smem[];
  const int taps = s.kh * s.kw;
  const int hw = kTW + s.kw - 1;
  const int hp = halo_pixels(s.kh, s.kw);
  unsigned* halo = smem;
  unsigned* wh = halo + hp * kLd;
  unsigned* wl = wh + taps * kBN * kWords;  // f32 only
  float* bias_s = reinterpret_cast<float*>(wh + (kF32 ? 2 : 1) * taps * kBN * kWords);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int tiles_w = (s.wo + kTW - 1) / kTW, tiles_h = (s.ho + kTH - 1) / kTH;
  const long long tile = blockIdx.x;
  const int ow0 = (int)(tile % tiles_w) * kTW;
  const int oh0 = (int)((tile / tiles_w) % tiles_h) * kTH;
  const long long img = tile / ((long long)tiles_w * tiles_h);
  const int f0 = blockIdx.y * kBN;
  const unsigned* xw = reinterpret_cast<const unsigned*>(x);
  const unsigned* ww = reinterpret_cast<const unsigned*>(w);
  const int cw = kF32 ? s.c : s.c / 2;  // words a pixel (or a weight row)

  for (int i = tid; i < kBN; i += kTcThreads) bias_s[i] = f0 + i < s.f ? bias[f0 + i] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c0 = 0; c0 < s.c; c0 += kCh) {
    const int cw0 = kF32 ? c0 : c0 / 2;
    __syncthreads();  // the previous chunk's products are done with the stage
    for (int i = tid; i < hp * kWords; i += kTcThreads) {
      const int p = i / kWords, k = i % kWords;
      const int ih = oh0 + p / hw - s.pt, iw = ow0 + p % hw - s.pl;
      unsigned v = 0u;
      if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w)
        v = xw[((img * s.h + ih) * s.w + iw) * cw + cw0 + k];
      halo[p * kLd + k] = v;
    }
    for (int i = tid; i < taps * kBN * kWords; i += kTcThreads) {
      const int row = i / kWords, k = i % kWords;  // row = tap * BN + n
      const int tap = row / kBN, ff = f0 + row % kBN;
      const unsigned v = ff < s.f ? ww[((long long)tap * s.f + ff) * cw + cw0 + k] : 0u;
      const int at = row * kWords + (k ^ (row & 4));
      if (kF32) {
        unsigned hi, lo;
        split_tf32(hi, lo, v);
        wh[at] = hi;
        wl[at] = lo;
      } else {
        wh[at] = v;
      }
    }
    __syncthreads();
    for (int ky = 0; ky < s.kh; ++ky) {
      for (int kx = 0; kx < s.kw; ++kx) {
        const int tap = ky * s.kw + kx;
        const unsigned* p0 = halo + ((warp + ky) * hw + g + kx) * kLd;
        const unsigned* p1 = p0 + 8 * kLd;
        unsigned a[4] = {p0[t], p1[t], p0[t + 4], p1[t + 4]};
        // B(k, n) words t and t + 4 of row n = 8 j + g, where the stage
        // swapped the halves of rows with g & 4
        const int k0 = t ^ (g & 4), k1 = (t + 4) ^ (g & 4);
        if (kF32) {
          unsigned ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(ah[e], al[e], a[e]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const unsigned* bh = wh + (tap * kBN + 8 * j + g) * kWords;
            const unsigned* bl = wl + (tap * kBN + 8 * j + g) * kWords;
            mma_tf32(acc[j], al, bh[k0], bh[k1]);
            mma_tf32(acc[j], ah, bl[k0], bl[k1]);
            mma_tf32(acc[j], ah, bh[k0], bh[k1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const unsigned* b = wh + (tap * kBN + 8 * j + g) * kWords;
            mma_bf16(acc[j], a, b[k0], b[k1]);
          }
        }
      }
    }
  }

  // acc[j][2e + i]: pixel g + 8 e of the warp's row, output 8 j + 2 t + i
  const int oh = oh0 + warp;
  if (oh >= s.ho) return;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ow = ow0 + g + 8 * e;
    if (ow >= s.wo) continue;
    T* yp = y + ((img * s.ho + oh) * s.wo + ow) * s.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = 8 * j + 2 * t + i;
        if (f0 + n < s.f) yp[f0 + n] = from_f32<T>(acc[j][2 * e + i] + bias_s[n]);
      }
  }
}

template <typename T, int NT>
int launch_tc(const void* x, const void* w, const void* bias, void* y, const Shape& s,
              void* stream) {
  const int bytes = 4 * tc_smem_words(std::is_same<T, float>::value, s.kh, s.kw, NT);
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_kxk_tc_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles = (long long)s.n * ((s.ho + kTH - 1) / kTH) * ((s.wo + kTW - 1) / kTW);
  const dim3 grid((unsigned)tiles, (unsigned)((s.f + 8 * NT - 1) / (8 * NT)));
  conv_kxk_tc_kernel<T, NT><<<grid, kTcThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

// the instance for F outputs: the fewest n8 tiles that cover F up to 64,
// else 64 outputs a block
template <typename T>
int dispatch_tc(const void* x, const void* w, const void* bias, void* y, const Shape& s,
                void* stream) {
  switch (s.f > 8 * kMaxNT ? kMaxNT : (s.f + 7) / 8) {
    case 1: return launch_tc<T, 1>(x, w, bias, y, s, stream);
    case 2: return launch_tc<T, 2>(x, w, bias, y, s, stream);
    case 3: return launch_tc<T, 3>(x, w, bias, y, s, stream);
    case 4: return launch_tc<T, 4>(x, w, bias, y, s, stream);
    case 5: return launch_tc<T, 5>(x, w, bias, y, s, stream);
    case 6: return launch_tc<T, 6>(x, w, bias, y, s, stream);
    case 7: return launch_tc<T, 7>(x, w, bias, y, s, stream);
    default: return launch_tc<T, 8>(x, w, bias, y, s, stream);
  }
}

// the output shape, or a refusal: an empty conv, a pad below zero or an
// output of no pixels
int make_shape(Shape& s, int n, int h, int w_img, int c, int kh, int kw, int f, int pt,
               int pb, int pl, int pr) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || kh <= 0 || kw <= 0 || f <= 0 || pt < 0 ||
      pb < 0 || pl < 0 || pr < 0)
    return cudaErrorInvalidValue;
  s = Shape{n, h, w_img, c, kh, kw, f, pt, pl, h + pt + pb - kh + 1, w_img + pl + pr - kw + 1};
  if (s.ho <= 0 || s.wo <= 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
int conv_kxk_tc(const void* x, const void* w, const void* bias, void* y, int n, int h,
                int w_img, int c, int kh, int kw, int f, int pt, int pb, int pl, int pr,
                void* stream) {
  Shape s;
  const int refused = make_shape(s, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr);
  if (refused) return refused;
  if (c % 16) return cudaErrorInvalidValue;
  if ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(w)) % 4)
    return cudaErrorMisalignedAddress;
  return dispatch_tc<T>(x, w, bias, y, s, stream);
}

template <typename T>
int conv_kxk_cc(const void* x, const void* w, const void* bias, void* y, int n, int h,
                int w_img, int c, int kh, int kw, int f, int pt, int pb, int pl, int pr,
                void* stream) {
  Shape s;
  const int refused = make_shape(s, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr);
  if (refused) return refused;
  const long long total = (long long)s.n * s.ho * s.wo * s.f;
  const unsigned blocks = (unsigned)((total + kCcThreads - 1) / kCcThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv_kxk_cc_kernel<T><<<blocks, kCcThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

// ---- weight gradient (CUDA cores, any shape) ----

constexpr int kGR = 64;   // rows (tap, channel) of a block's tile
constexpr int kGF = 64;   // outputs of a block's tile
constexpr int kGK = 16;   // pixels a step
constexpr int kGTM = 4;   // rows of a thread
constexpr int kGTN = 4;   // outputs of a thread
constexpr int kGThreads = (kGR / kGTM) * (kGF / kGTN);

// Block (row tile blockIdx.x, output tile blockIdx.y, split blockIdx.z):
// sums the split's pixels [z chunk, (z + 1) chunk) into ws[z][row][f]. Row r
// < kh kw C is (tap, channel) = (r / C, r % C); row kh kw C is the ones of
// db. A thread's sums run over the pixels in order.
template <typename T>
__global__ void __launch_bounds__(kGThreads)
    conv_kxk_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          float* __restrict__ ws, Shape s, int chunk) {
  __shared__ float a_s[kGK][kGR + 4];
  __shared__ float g_s[kGK][kGF + 4];
  const int tid = threadIdx.x;
  const int rows = s.kh * s.kw * s.c;  // + 1 for db
  const int r0 = blockIdx.x * kGR, f0 = blockIdx.y * kGF;
  const long long m = (long long)s.n * s.ho * s.wo;
  const long long p_begin = (long long)blockIdx.z * chunk;
  const long long p_end = p_begin + chunk < m ? p_begin + chunk : m;
  const int tx = tid % (kGF / kGTN), ty = tid / (kGF / kGTN);
  float acc[kGTM][kGTN];
#pragma unroll
  for (int i = 0; i < kGTM; ++i)
#pragma unroll
    for (int j = 0; j < kGTN; ++j) acc[i][j] = 0.f;

  for (long long p0 = p_begin; p0 < p_end; p0 += kGK) {
    for (int e = tid; e < kGK * kGR; e += kGThreads) {
      const int k = e / kGR, r = r0 + e % kGR;
      const long long p = p0 + k;
      float v = 0.f;
      if (p < p_end && r <= rows) {
        if (r == rows) {
          v = 1.f;
        } else {
          const int tap = r / s.c, c = r % s.c;
          const int ow = (int)(p % s.wo), oh = (int)((p / s.wo) % s.ho);
          const long long img = p / ((long long)s.wo * s.ho);
          const int ih = oh + tap / s.kw - s.pt, iw = ow + tap % s.kw - s.pl;
          if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w)
            v = to_f32(x[((img * s.h + ih) * s.w + iw) * s.c + c]);
        }
      }
      a_s[k][e % kGR] = v;
    }
    for (int e = tid; e < kGK * kGF; e += kGThreads) {
      const int k = e / kGF, f = f0 + e % kGF;
      const long long p = p0 + k;
      g_s[k][e % kGF] = p < p_end && f < s.f ? to_f32(g[p * s.f + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGK; ++k) {
      float a[kGTM], b[kGTN];
#pragma unroll
      for (int i = 0; i < kGTM; ++i) a[i] = a_s[k][ty * kGTM + i];
#pragma unroll
      for (int j = 0; j < kGTN; ++j) b[j] = g_s[k][tx * kGTN + j];
#pragma unroll
      for (int i = 0; i < kGTM; ++i)
#pragma unroll
        for (int j = 0; j < kGTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = ws + (long long)blockIdx.z * (rows + 1) * s.f;
#pragma unroll
  for (int i = 0; i < kGTM; ++i) {
    const int r = r0 + ty * kGTM + i;
    if (r > rows) continue;
#pragma unroll
    for (int j = 0; j < kGTN; ++j) {
      const int f = f0 + tx * kGTN + j;
      if (f < s.f) out[(long long)r * s.f + f] = acc[i][j];
    }
  }
}

// out[i] = the sum of ws[z][i] over the splits z, in order
__global__ void __launch_bounds__(256)
    conv_kxk_sum_splits_kernel(const float* __restrict__ ws, float* __restrict__ out, long long size,
                      int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= size) return;
  float v = ws[i];
  for (int z = 1; z < splits; ++z) v += ws[(long long)z * size + i];
  out[i] = v;
}

template <typename T>
int conv_kxk_wgrad(const void* x, const void* g, void* ws, void* out, int n, int h, int w_img,
                   int c, int kh, int kw, int f, int pt, int pb, int pl, int pr, int splits,
                   int chunk, void* stream) {
  Shape s;
  const int refused = make_shape(s, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr);
  if (refused) return refused;
  const long long m = (long long)s.n * s.ho * s.wo;
  // every split must hold pixels: none empty, none past the end
  if (splits <= 0 || chunk <= 0 || (long long)(splits - 1) * chunk >= m ||
      (long long)splits * chunk < m)
    return cudaErrorInvalidValue;
  const int rows = kh * kw * c + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((rows + kGR - 1) / kGR), (unsigned)((f + kGF - 1) / kGF),
                  (unsigned)splits);
  conv_kxk_wgrad_kernel<T><<<grid, kGThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(ws), s, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long size = (long long)rows * f;
  conv_kxk_sum_splits_kernel<<<(unsigned)((size + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), size, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. x: (n, h, w, c) contiguous; w: the
// kernel as [kh kw][f][c] contiguous in the dtype of x (ops/conv_kxk.py
// `entry_weight`); bias: (f,) f32; y: (n, ho, wo, f) with ho = h + pt + pb -
// kh + 1, wo = w + pl + pr - kw + 1. The launch goes on `stream` and does not
// synchronise; the return value is cudaGetLastError() right after the launch
// (0 = launched), or cudaErrorInvalidValue / cudaErrorMisalignedAddress for
// what an entry does not take, with nothing launched.
extern "C" int conv_kxk_f32(const void* x, const void* w, const void* bias, void* y, int n,
                            int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                            int pl, int pr, void* stream) {
  return conv_kxk_cc<float>(x, w, bias, y, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr, stream);
}

extern "C" int conv_kxk_bf16(const void* x, const void* w, const void* bias, void* y, int n,
                             int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                             int pl, int pr, void* stream) {
  return conv_kxk_cc<__nv_bfloat16>(x, w, bias, y, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                                    stream);
}

// the tensor-core entries: C a multiple of 16, x and w 4-byte aligned
extern "C" int conv_kxk_f32_tc(const void* x, const void* w, const void* bias, void* y, int n,
                               int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                               int pl, int pr, void* stream) {
  return conv_kxk_tc<float>(x, w, bias, y, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr, stream);
}

extern "C" int conv_kxk_bf16_tc(const void* x, const void* w, const void* bias, void* y, int n,
                                int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                                int pl, int pr, void* stream) {
  return conv_kxk_tc<__nv_bfloat16>(x, w, bias, y, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                                    stream);
}

// The weight gradient: x (n, h, w, c) and g (n, ho, wo, f) contiguous, of
// one dtype; ws: (splits, kh kw c + 1, f) f32 scratch; out: (kh kw c + 1, f)
// f32, dW as the HWIO kernel reshaped to (kh kw c, f), then db. The output
// pixels are cut into `splits` runs of `chunk` (none empty).
extern "C" int conv_kxk_wgrad_f32(const void* x, const void* g, void* ws, void* out, int n,
                                  int h, int w_img, int c, int kh, int kw, int f, int pt,
                                  int pb, int pl, int pr, int splits, int chunk, void* stream) {
  return conv_kxk_wgrad<float>(x, g, ws, out, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                               splits, chunk, stream);
}

extern "C" int conv_kxk_wgrad_bf16(const void* x, const void* g, void* ws, void* out, int n,
                                   int h, int w_img, int c, int kh, int kw, int f, int pt,
                                   int pb, int pl, int pr, int splits, int chunk,
                                   void* stream) {
  return conv_kxk_wgrad<__nv_bfloat16>(x, g, ws, out, n, h, w_img, c, kh, kw, f, pt, pb, pl,
                                       pr, splits, chunk, stream);
}
