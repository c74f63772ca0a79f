// Fused Winograd ResBlock, NHWC, for Hopper.
//
// Replaces the TPU kernels `wino_packed_resblock` (F(2,3)) and
// `wino4_packed_resblock` (F(4,3)) of larvanet_tpu/ops/wino_pallas.py
// (:205-257 and :336-382; bodies `_resblock_kernel` :155-202 and
// `_resblock4_kernel` :294-333). One launch computes a whole EDSR ResBlock,
//
//     y = x + rw * (conv_b(t) + b_b),   t = ReLU(conv_a(x) + b_a),
//
// with each SAME 3x3 conv in 1-D Winograd F(m, 3) along H (P = m + 2 basis
// taps for m output rows) and the 3 direct taps along W. The intermediate t
// never leaves shared memory. Numerics follow the TPU kernel: transforms in
// f32, the point-product operands rounded to the activation dtype (T) and
// summed in f32, t kept in f32 and zero outside the image, bias / ReLU /
// rw / residual in f32 and one cast to T. The weights come pre-transformed,
// U[p, kw] = sum_kh G[p, kh] k[kh, kw], shaped (P, 3, C, C) in T.
//
// Design: a block owns TH = GB*m output rows x TW output columns of one
// image and all C = 64 channels. Stage A computes t on the window of
// (TH + 2) x (TW + 2) pixels that stage B needs, in GB + 1 groups of m
// rows starting one row above the tile, and stores it in shared memory
// (zero where the pixel lies outside the image: conv_b's SAME padding must
// see zeros there, not ReLU(b_a)). Stage B reads t from shared memory and
// writes the tile. Each stage is a set of P GEMMs, M[p] = V_p (pixel groups
// x 3C) * U_p (3C x C), run like the conv3x3 kernel: 64 pixel groups x 64
// channels per round, 4x4 per thread, K in BK slices. The input transform
// V_p = B^T d is applied while a K slice is gathered into shared memory
// (all P basis taps from one read of the m + 2 rows), the thread keeps all
// P accumulators, and the epilogue applies A^T, so the m + 2 input rows are
// read once per slice and not once per basis tap. Stage A reads x through
// L1 / L2; the residual is read again in stage B's epilogue.
//
// Bound on an H100 SXM (67 TFLOP/s f32 CUDA core, 989 TFLOP/s bf16 tensor,
// 3.35 TB/s HBM). Per output pixel the Winograd form needs 2 x (P*3/m) C^2
// multiply-adds: 12 C^2 for F(2,3) and 9 C^2 for F(4,3), against 18 C^2 for
// the direct ResBlock. At 4 x 192x192 LR pixels and C = 64 that is 14.5
// GFLOP (F(2,3)) in f32, 0.22 ms at the f32 peak, against 75 MB of x + out
// (22 us at the HBM rate): bound by operations. The tiling recomputes t
// on the window's 2-pixel rim and fills rounds of 64 groups partly, so the
// kernel does 16 C^2 (F(2,3)) and 14.4 C^2 (F(4,3)) per pixel.
//
// What this simple design leaves on the table: CUDA cores only (no
// mma.sync / wgmma), so bf16 runs at the f32 rate; synchronous staging
// with two barriers per K slice; U streamed from L2 for every slice of
// every round; x gathered m + 2 times per group from L1 / L2.

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

// a point-product operand: rounded to the activation dtype, held in f32
template <typename T>
__device__ __forceinline__ float round_op(float v) { return to_f32(from_f32<T>(v)); }

template <int M>
struct Wino;

// F(2,3), points {0, 1, -1, inf}; wino_pallas.py `_bt` / `_stage`
template <>
struct Wino<2> {
  __device__ static __forceinline__ void bt(const float (&d)[4], float (&v)[4]) {
    v[0] = d[0] - d[2];
    v[1] = d[1] + d[2];
    v[2] = d[2] - d[1];
    v[3] = d[1] - d[3];
  }
  __device__ static __forceinline__ void at(const float (&m)[4], float (&y)[2]) {
    y[0] = m[0] + m[1] + m[2];
    y[1] = m[1] - m[2] - m[3];
  }
};

// F(4,3), points {0, +-1, +-2, inf}; wino_pallas.py `_BT6` / `_AT46`
template <>
struct Wino<4> {
  __device__ static __forceinline__ void bt(const float (&d)[6], float (&v)[6]) {
    v[0] = d[0] * 4.f + d[2] * -5.f + d[4];
    v[1] = d[1] * -4.f + d[2] * -4.f + d[3] + d[4];
    v[2] = d[1] * 4.f + d[2] * -4.f - d[3] + d[4];
    v[3] = d[1] * -2.f - d[2] + d[3] * 2.f + d[4];
    v[4] = d[1] * 2.f - d[2] + d[3] * -2.f + d[4];
    v[5] = d[1] * 4.f + d[3] * -5.f + d[5];
  }
  __device__ static __forceinline__ void at(const float (&m)[6], float (&y)[4]) {
    y[0] = m[0] + m[1] + m[2] + m[3] + m[4];
    y[1] = m[1] - m[2] + m[3] * 2.f + m[4] * -2.f;
    y[2] = m[1] + m[2] + m[3] * 4.f + m[4] * 4.f;
    y[3] = m[1] - m[2] + m[3] * 8.f + m[4] * -8.f + m[5];
  }
};

constexpr int kC = 64;        // channels (EDSR-baseline's width)
constexpr int kThreads = 256;
constexpr int kTM = 4;        // pixel groups per thread
constexpr int kTN = 4;        // channels per thread
constexpr int kBM = (kThreads / (kC / kTN)) * kTM;  // 64 pixel groups per round
constexpr int kK = 3 * kC;    // GEMM depth: kw-major, channel-minor
constexpr int kAsLd = kBM + 4;  // +4: 16-byte rows, conflict-free column stores

template <int M, int GB, int TW, int BK>
struct Tile {
  static constexpr int P = M + 2;
  static constexpr int TH = GB * M;   // output rows
  static constexpr int GA = GB + 1;   // stage-A groups: t rows [-1, TH + 1)
  static constexpr int TR = TH + 2;   // t rows kept
  static constexpr int TC = TW + 2;   // t columns kept
  static constexpr int kTFloats = TR * TC * kC;
  static constexpr int kAsFloats = P * BK * kAsLd;
  static constexpr int kUsFloats = P * BK * kC;
  static constexpr int kSmemBytes = 4 * (kTFloats + kAsFloats + kUsFloats);
  static constexpr int kRowStep = kThreads / BK;
  static constexpr int kStageRows = kBM * BK / kThreads;  // gathered groups per thread
  static_assert(kK % BK == 0, "K slices must tile 3C");
  static_assert(kThreads % BK == 0 && (kBM * BK) % kThreads == 0, "gather must split evenly");
};

// One stage: the Winograd conv over the stage's pixel groups.
//   stage A (kB = false): source x (global, zero outside the image); writes
//     t = ReLU(conv_a + b_a) into ts, zero outside the image.
//   stage B (kB = true): source ts; writes y = x + rw * (conv_b + b_b).
template <typename T, int M, int GB, int TW, int BK, bool kB>
__device__ __forceinline__ void stage(const T* __restrict__ xn, const T* __restrict__ u,
                                      const float* __restrict__ bias, float* ts, float* as,
                                      float* us, T* __restrict__ yn, float rw, int h_img,
                                      int w_img, int h0, int w0) {
  using Tl = Tile<M, GB, TW, BK>;
  using W = Wino<M>;
  constexpr int P = Tl::P;
  constexpr int WS = kB ? TW : Tl::TC;  // group columns
  constexpr int NPG = (kB ? GB : Tl::GA) * WS;
  constexpr int ROUNDS = (NPG + kBM - 1) / kBM;
  constexpr int SR = Tl::kStageRows;

  const int tid = threadIdx.x;
  const int k_col = tid % BK;
  const int srow0 = tid / BK;
  const int tx = tid % (kC / kTN);
  const int ty = tid / (kC / kTN);

  for (int round = 0; round < ROUNDS; ++round) {
    const int pg0 = round * kBM;
    // the gather rows of this thread: first source row and column of the group
    int row_base[SR];
    int col_base[SR];
    bool ok[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int pg = pg0 + srow0 + i * Tl::kRowStep;
      const int g = pg / WS;
      const int c = pg % WS;
      ok[i] = pg < NPG;
      // stage A: global rows h0 - 2 + g*M .. + M + 1, columns w0 - 2 + c + kw
      // stage B: t-local rows g*M .. + M + 1, columns c + kw
      row_base[i] = kB ? g * M : h0 - 2 + g * M;
      col_base[i] = kB ? c : w0 - 2 + c;
    }

    float acc[P][kTM][kTN];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[p][i][j] = 0.f;

    for (int k0 = 0; k0 < kK; k0 += BK) {
      const int k = k0 + k_col;
      const int kw = k / kC;
      const int ci = k % kC;
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        float d[P];
        const int cc = col_base[i] + kw;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int r = row_base[i] + j;
          float v = 0.f;
          if constexpr (kB) {
            if (ok[i]) v = ts[(r * Tl::TC + cc) * kC + ci];
          } else {
            if (ok[i] && r >= 0 && r < h_img && cc >= 0 && cc < w_img)
              v = to_f32(xn[((long long)r * w_img + cc) * kC + ci]);
          }
          d[j] = v;
        }
        float v[P];
        W::bt(d, v);
        const int q = srow0 + i * Tl::kRowStep;
#pragma unroll
        for (int p = 0; p < P; ++p) as[(p * BK + k_col) * kAsLd + q] = round_op<T>(v[p]);
      }
      for (int e = tid; e < P * BK * kC; e += kThreads) {
        const int p = e / (BK * kC);
        const int rem = e - p * (BK * kC);
        us[e] = to_f32(u[((long long)p * kK + k0) * kC + rem]);
      }
      __syncthreads();
#pragma unroll
      for (int kb = 0; kb < BK; ++kb) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float4 a = *reinterpret_cast<const float4*>(&as[(p * BK + kb) * kAsLd + ty * kTM]);
          const float4 b = *reinterpret_cast<const float4*>(&us[(p * BK + kb) * kC + tx * kTN]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[p][i][j] = fmaf(av[i], bv[j], acc[p][i][j]);
        }
      }
      __syncthreads();
    }

    // epilogue: A^T, bias, then ReLU into ts (A) or the residual into y (B)
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int pg = pg0 + ty * kTM + i;
      if (pg >= NPG) continue;
      const int g = pg / WS;
      const int c = pg % WS;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int co = tx * kTN + j;
        float mv[P];
#pragma unroll
        for (int p = 0; p < P; ++p) mv[p] = acc[p][i][j];
        float yv[M];
        W::at(mv, yv);
        const float bv = bias[co];
#pragma unroll
        for (int r = 0; r < M; ++r) {
          if constexpr (!kB) {
            const int trow = g * M + r;  // t-local row: global h0 - 1 + trow
            if (trow >= Tl::TR) continue;
            const int gh = h0 - 1 + trow;
            const int gw = w0 - 1 + c;
            const bool inside = gh >= 0 && gh < h_img && gw >= 0 && gw < w_img;
            ts[(trow * Tl::TC + c) * kC + co] = inside ? fmaxf(yv[r] + bv, 0.f) : 0.f;
          } else {
            const int gh = h0 + g * M + r;
            const int gw = w0 + c;
            if (gh < h_img && gw < w_img) {
              const long long off = ((long long)gh * w_img + gw) * kC + co;
              yn[off] = from_f32<T>(to_f32(xn[off]) + (yv[r] + bv) * rw);
            }
          }
        }
      }
    }
  }
}

template <typename T, int M, int GB, int TW, int BK>
__global__ void __launch_bounds__(kThreads)
    wino_resblock_kernel(const T* __restrict__ x, const T* __restrict__ ua,
                         const float* __restrict__ ba, const T* __restrict__ ub,
                         const float* __restrict__ bb, T* __restrict__ y, float rw, int h_img,
                         int w_img) {
  using Tl = Tile<M, GB, TW, BK>;
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;                      // [TR][TC][C] t window, f32
  float* as = ts + Tl::kTFloats;         // [P][BK][kAsLd] transformed input slice
  float* us = as + Tl::kAsFloats;        // [P][BK][C] weight slice
  const long long image = (long long)blockIdx.z * h_img * w_img * kC;
  const int h0 = blockIdx.y * Tl::TH;
  const int w0 = blockIdx.x * TW;
  stage<T, M, GB, TW, BK, false>(x + image, ua, ba, ts, as, us, y + image, rw, h_img, w_img,
                                 h0, w0);
  __syncthreads();
  stage<T, M, GB, TW, BK, true>(x + image, ub, bb, ts, as, us, y + image, rw, h_img, w_img,
                                h0, w0);
}

template <typename T, int M, int GB, int TW, int BK>
int launch(const void* x, const void* ua, const void* ba, const void* ub, const void* bb,
           void* y, float rw, int n, int h, int w, void* stream) {
  using Tl = Tile<M, GB, TW, BK>;
  auto kernel = wino_resblock_kernel<T, M, GB, TW, BK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tl::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((w + TW - 1) / TW), (unsigned)((h + Tl::TH - 1) / Tl::TH),
                  (unsigned)n);
  kernel<<<grid, kThreads, Tl::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(ua), static_cast<const float*>(ba),
      static_cast<const T*>(ub), static_cast<const float*>(bb), static_cast<T*>(y), rw, h, w);
  return (int)cudaGetLastError();
}

// Tiles: F(2,3) 12 x 16 outputs (t window 14 x 18, 98 KB of shared memory);
// F(4,3) 8 x 30 outputs (t window 10 x 32, 107 KB). Shared memory would fit
// two blocks an SM; at 175 and 215 registers a thread (-Xptxas -v) one runs.
constexpr int kF2Groups = 6, kF2Width = 16, kF2Slice = 16;
constexpr int kF4Groups = 2, kF4Width = 30, kF4Slice = 8;

}  // namespace

// Plain C entry points for ctypes. x, y: (n, h, w, 64) contiguous in the
// entry's dtype; ua, ub: (m + 2, 3, 64, 64) contiguous, same dtype; ba, bb:
// (64,) f32. The launch goes on `stream` and does not synchronise; the
// return value is the CUDA error of the launch (0 = launched).
extern "C" int wino_resblock_f2_f32(const void* x, const void* ua, const void* ba,
                                    const void* ub, const void* bb, void* y, float rw, int n,
                                    int h, int w, void* stream) {
  return launch<float, 2, kF2Groups, kF2Width, kF2Slice>(x, ua, ba, ub, bb, y, rw, n, h, w,
                                                         stream);
}

extern "C" int wino_resblock_f2_bf16(const void* x, const void* ua, const void* ba,
                                     const void* ub, const void* bb, void* y, float rw, int n,
                                     int h, int w, void* stream) {
  return launch<__nv_bfloat16, 2, kF2Groups, kF2Width, kF2Slice>(x, ua, ba, ub, bb, y, rw, n,
                                                                 h, w, stream);
}

extern "C" int wino_resblock_f4_f32(const void* x, const void* ua, const void* ba,
                                    const void* ub, const void* bb, void* y, float rw, int n,
                                    int h, int w, void* stream) {
  return launch<float, 4, kF4Groups, kF4Width, kF4Slice>(x, ua, ba, ub, bb, y, rw, n, h, w,
                                                         stream);
}

extern "C" int wino_resblock_f4_bf16(const void* x, const void* ua, const void* ba,
                                     const void* ub, const void* bb, void* y, float rw, int n,
                                     int h, int w, void* stream) {
  return launch<__nv_bfloat16, 4, kF4Groups, kF4Width, kF4Slice>(x, ua, ba, ub, bb, y, rw, n,
                                                                 h, w, stream);
}
