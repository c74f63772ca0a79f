// Fused SAME 3x3 convolution + bias + activation, NHWC x HWIO, for Hopper.
//
// Replaces the TPU kernel `conv3x3_bias_act_pallas`
// (larvanet_tpu/ops/pallas_conv.py:61-131): the same function, y =
// act(conv3x3_same(x, k) + b) with act in {none, relu, leaky_relu(0.1)},
// accumulated in f32 and stored in the input dtype (f32 or bf16). In the
// port it carries every 3x3 conv of the EDSR forward (37 launches per x4
// forward).
//
// Design: an implicit GEMM on CUDA cores. M = N*H*W output pixels,
// K = 9*C (tap-major, channel-minor: the HWIO kernel reshaped to (9C, F)),
// N_gemm = F. A block owns a BM x BN output tile and walks K in BK slices:
// each slice of the virtual im2col matrix is gathered straight from x into
// shared memory, with the SAME zero padding computed by masks on the
// pixel's (h, w) -- there is no padded copy of x and no im2col buffer in
// device memory. Each thread keeps a TM x TN f32 accumulator in registers
// and the epilogue adds the bias, applies the activation and masks the
// ragged edges in M (last rows of the last image) and F (F = 3, 256, 576).
// Two tile shapes: 128x64 for wide outputs and 256x4 for F <= 4 (the
// final 64->3 conv), so the narrow conv does not pay for 60 idle columns.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32 CUDA
// core, 3.35 TB/s HBM). At batch 16 of 192x192 LR tiles a 64->64 trunk
// conv is 43.5 GFLOP and 151 MB in bf16: 44 us at the tensor-core peak
// against 45 us at the memory rate, so it sits on the ridge. The first
// 64->256 upsample conv is 174 GFLOP, 176 us. In f32 on CUDA cores the
// same trunk conv is bound by operations: 650 us at 67 TFLOP/s.
//
// What this simple design leaves on the table: it never touches the
// tensor cores (no mma.sync / wgmma), so bf16 runs at the f32 CUDA-core
// rate; the loads are synchronous (no cp.async / TMA pipeline, one
// buffer, two barriers per K slice); the gathered A tile is reused BN
// times but each input pixel is still fetched 9 times from L2 (once per
// tap); and the shared-memory reads feed only TM*TN FMAs per TM+TN loads.
// A later kernel: wgmma on bf16 tiles fed by TMA, with the 3 rows of
// halo kept in shared memory across the 9 taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv3x3_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ bias, T* __restrict__ y,
                            int n, int h_img, int w_img, int c, int f, int act) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  static_assert(kThreads % BK == 0, "each thread gathers one fixed k column");
  static_assert((BM * BK) % kThreads == 0, "A tile must split evenly");
  constexpr int kRowStep = kThreads / BK;
  constexpr int kRowsPerThread = BM * BK / kThreads;

  // +4 keeps rows 16-byte aligned and spreads the column-wise stores
  __shared__ float a_s[BK][BM + 4];
  __shared__ float b_s[BK][BN];
  // (h, w) of each output pixel of the tile; -4 marks rows past M so that
  // every tap of them fails the bounds test below
  __shared__ int pix_h[BM];
  __shared__ int pix_w[BM];

  const int tid = threadIdx.x;
  const long long m_total = (long long)n * h_img * w_img;
  const long long m0 = (long long)blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;
  const int k_total = 9 * c;

  for (int i = tid; i < BM; i += kThreads) {
    const long long m = m0 + i;
    if (m < m_total) {
      pix_w[i] = (int)(m % w_img);
      pix_h[i] = (int)((m / w_img) % h_img);
    } else {
      pix_h[i] = -4;
      pix_w[i] = -4;
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // gather mapping: neighbouring threads read neighbouring channels of one
  // pixel (contiguous in NHWC)
  const int k_col = tid % BK;
  const int row0 = tid / BK;
  // compute mapping: tx over output channels, ty over pixels
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    const int k = k0 + k_col;
    const bool k_in = k < k_total;
    const int tap = k_in ? k / c : 0;
    const int ch = k - tap * c;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    // element offset of the tap's neighbour relative to the pixel itself
    const long long shift = ((long long)dy * w_img + dx) * c + ch;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row0 + i * kRowStep;
      const int hh = pix_h[row] + dy;
      const int ww = pix_w[row] + dx;
      float v = 0.f;
      if (k_in && hh >= 0 && hh < h_img && ww >= 0 && ww < w_img)
        v = to_f32(x[(m0 + row) * c + shift]);
      a_s[k_col][row] = v;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kb = e / BN;
      const int j = e % BN;
      const int kk = k0 + kb;
      const int ff = f0 + j;
      b_s[kb][j] = (kk < k_total && ff < f) ? to_f32(w[(long long)kk * f + ff]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BK; ++kb) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_s[kb][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_s[kb][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int ff = f0 + tx * TN + j;
      if (ff >= f) continue;
      float v = acc[i][j] + bias[ff];
      if (act == kRelu) {
        v = fmaxf(v, 0.f);
      } else if (act == kLeakyRelu) {
        v = v >= 0.f ? v : 0.1f * v;
      }
      y[m * f + ff] = from_f32<T>(v);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, const void* bias, void* y, int n, int h, int w_img,
            int c, int f, int act, cudaStream_t stream) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  const long long m_total = (long long)n * h * w_img;
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((f + BN - 1) / BN));
  conv3x3_bias_act_kernel<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), n, h, w_img, c, f, act);
}

template <typename T>
int conv3x3_bias_act(const void* x, const void* w, const void* bias, void* y, int n, int h,
                     int w_img, int c, int f, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f <= 4) {
    launch<T, 256, 4, 16, 1, 4>(x, w, bias, y, n, h, w_img, c, f, act, s);
  } else {
    launch<T, 128, 64, 16, 8, 4>(x, w, bias, y, n, h, w_img, c, f, act, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. x: (n, h, w, c) contiguous; w: (9c, f)
// contiguous in the dtype of x; bias: (f,) f32; y: (n, h, w, f). The launch
// goes on `stream` and does not synchronise; the return value is
// cudaGetLastError() right after the launch (0 = launched).
extern "C" int conv3x3_bias_act_f32(const void* x, const void* w, const void* bias, void* y,
                                    int n, int h, int w_img, int c, int f, int act,
                                    void* stream) {
  return conv3x3_bias_act<float>(x, w, bias, y, n, h, w_img, c, f, act, stream);
}

extern "C" int conv3x3_bias_act_bf16(const void* x, const void* w, const void* bias, void* y,
                                     int n, int h, int w_img, int c, int f, int act,
                                     void* stream) {
  return conv3x3_bias_act<__nv_bfloat16>(x, w, bias, y, n, h, w_img, c, f, act, stream);
}
