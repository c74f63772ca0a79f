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
// never leaves shared memory. Numerics follow the TPU kernel
// (wino_pallas.py:143-144, 185-189): the input transform B^T d in f32 and
// rounded once to the activation dtype (T), point products of T operands
// summed in f32, A^T, bias, ReLU, rw and the residual in f32, t kept in f32
// and zero outside the image, one cast of the output to T. The weights come
// pre-transformed, U[p, kw] = sum_kh G[p, kh] k[kh, kw], (P, 3, C, C) in T.
// Per output pixel the Winograd form needs 2 x (P*3/m) C^2 multiply-adds:
// 12 C^2 for F(2,3) and 9 C^2 for F(4,3), against 18 C^2 for the direct
// ResBlock. C = 64 (EDSR-baseline). ops/wino_resblock.py `path_for` sends
// both dtypes to the tensor cores; the CUDA-core entries stay as the
// earlier kernels of both:
//
// Tensor-core path, `wino_resblock_f{2,4}_bf16_tc` (bf16). Bound on an H100
// SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM) at 4 x 192x192 LR: F(2,3)
// 14.5 GFLOP, 14.7 us, bound by operations (x and y, 37.7 MB, take 11.3
// us); F(4,3) 10.9 GFLOP, 11.0 us, under its bytes' 11.4 us. Each block owns a
// tile of TH x 30 outputs and walks tiles persistently, one block an SM.
// Per tile and stage (A: x -> t, B: t -> y) it transforms its input once
// into a window V = B^T d in shared memory, bf16, [p][group row][column]
// [channel] with a pixel stride of C + 8 values, then runs P steps of point
// products on mma.sync.m16n8k16 (bf16 in, f32 accumulate): M = 16
// consecutive columns of one group row, N = the output channels, K = 3 kw
// x C. The kw tap is a shift of the A operand's rows by kw pixels, so each
// transformed value is computed once and read three times. Operands load
// with ldmatrix; the C + 8 stride puts the 8 rows of every ldmatrix phase
// in distinct banks at every kw shift (WMMA's loads need 32-byte aligned
// tiles, which forces a 16-value multiple and a 2-way conflict on every A
// load). Each U_p slab (3 x C x C, transposed to [kw][co][ci] by the
// wrapper's weight cache so that B loads untransposed, rows of C + 8)
// comes by cp.async into one of two buffers while the products of the
// previous p run. A warp keeps all P accumulators of its unit (the two M
// tiles of one group row x 16 or 32 channels: 2 A and NQ B loads per 2 NQ
// products) in registers; the epilogue applies A^T
// element by element across them (every accumulator has the same register
// layout) and writes from the registers: stage A ReLU(. + b_a) as f32 into
// t (a border tile then zeroes t outside the image), stage B x + rw (. +
// b_b), rounded once, into y, masked at the ragged edges. During stage B
// the next tile's x window (cp.async, zero-filled outside the image) lands
// in t's bytes, this tile's residual x in V's unused tail, and the last
// step copies the next tile's first slab.
//   F(2,3): 6 x 30 outputs, 8 warps, units of 2 M tiles x 32 channels (8
//     in stage A, 6 in B), 203,776 bytes of dynamic shared memory (t 69,632;
//     V 78,336; slabs 55,296; biases 512), 255 registers.
//   F(4,3): 8 x 30 outputs, 12 warps, units of 2 M tiles x 16 channels
//     (12 in A, 8 in B), 231,040 bytes (t 87,040; V 88,192; slabs 55,296;
//     biases 512), 168 registers. At 4 x 30 (8 warps) it ran 1.4x slower: twice the tiles
//     for the same fixed costs per tile, and stage A computed 8 t rows
//     for 6.
// What holds it back (it runs at ~8x / ~12x its bound): mma.sync at a
// fraction of wgmma's rate, with every warp reloading its B operands from
// shared memory (2 A + NQ B ldmatrix per 2 NQ products), so the products run
// near the shared-memory bandwidth; one block an SM runs its transforms,
// products and epilogues one after another, with no warp specialisation to
// overlap them; stage B leaves 2 (F(2,3)) or 4 (F(4,3)) warps idle; the
// 30-column tile wastes 9% of its columns at W = 192.
//
// Tensor-core path in f32, `wino_resblock_f{2,4}_f32_tc` (split TF32).
// Bound on an H100 SXM: f32-accurate products on the tensor cores run at
// 495 / 3 = 165 TFLOP/s (three TF32 products an f32 product), so at 4 x
// 192x192 LR F(2,3) (14.5 GFLOP) takes 88 us and F(4,3) (10.9 GFLOP) 66
// us, bound by operations (x and y, 75.5 MB, take 22.5 us). One TF32
// product keeps 11 bits of each operand, far from the f32 bar over sums
// of 3 x 64 products, so each operand is split into tf32 parts, v = hi +
// lo (hi = rna(v), lo = rna(v - hi)), and a x b is taken as lo_a hi_b +
// hi_a lo_b + hi_a hi_b on mma.sync.m16n8k8 tf32 with f32 sums, small
// products first: V = B^T d stays unrounded f32 in shared memory and is
// split with cvt.rna as each A operand is loaded (once per k-step for all
// of a warp's n8 tiles); the weights U come split once per weight by the
// wrapper, hi then lo, with the bf16 path's swapped channel axes. The
// structure is the bf16 path's (persistent blocks, the same tiles, stage A
// into t in shared memory, stage B into y, A^T element by element across
// the P accumulators, masked edges, t zeroed outside the image), and
// shared memory is what runs out first: in f32 the x window alone is 87
// KB (F(2,3)) / 122 KB (F(4,3)) and V of all P taps 148 KB / 167 KB, so
// the block builds V one basis tap at a time (V_p, read three times at the
// kw shifts, then the next) and streams the weights through a cp.async
// ring of two (p, kw) slabs, hi and lo (35 KB a slab), one barrier a slab.
// Pixel strides of C + 4 floats (272 bytes, an odd multiple of 16) in V, t
// and the slabs put the 8 rows of every ldmatrix phase in distinct banks
// at every kw shift. The x window shares its bytes with t (written only
// after stage A's last product); the next tile's window is copied into
// them from stage B's last slab on, once t's last V_p is built; the
// residual is read in the epilogue from global memory, where the tile's x
// window was read moments before (L2).
//   F(2,3): 6 x 30 outputs, 16 warps, units of 2 M tiles x 16 channels
//     (16 in stage A, 12 in B), 194,176 bytes of dynamic shared memory (x
//     window / t 87,040; V_p 36,992; slabs 69,632; biases 512), 128
//     registers (the cap at 512 threads), no spills. At 8 warps with 32
//     channels a unit (165 registers) it ran level; with the kw loop
//     unrolled it spilled and ran slower (the unrolled code also slowed
//     F(4,3): 1,152 HMMA a kernel already).
//   F(4,3): 8 x 30 outputs, 12 warps, units of 2 M tiles x 16 channels
//     (12 in A, 8 in B), 219,776 bytes (x window / t 121,856; V_p 27,776;
//     slabs 69,632; biases 512), 165 registers, no spills.
// What holds it back (it runs at ~6.7x / ~9x its bound, ~1.7x faster than
// cuDNN's f32 ResBlock, PERF.md): the products take about half the time
// and the A operands' split about a quarter (it is redone at every
// k-step and kw shift, shared by a unit's 2 n8 tiles only); the rest is
// mostly the weights: every tile streams the split basis of both convs
// through the slab ring (749 / 842 MB from L2 a launch at 4 x 192x192),
// behind a barrier every 96 products a warp. Stage B leaves 4 warps idle,
// and F(4,3)'s 672 tiles take 6 rounds of 132 SMs. wgmma (tf32 from
// shared memory, so V could be split once per value) with larger tiles or
// a resident basis is the next step.
//
// CUDA-core path, `wino_resblock_f{2,4}_{f32,bf16}`, the earlier kernels of
// both functions (f32 ran here until the split-TF32 entries came). A block
// owns TH = GB*m output rows x TW output columns and all C channels. Stage
// A computes t
// on the window of (TH + 2) x (TW + 2) pixels that stage B needs, in GB + 1
// groups of m rows starting one row above the tile, and stores it in
// shared memory (zero outside the image). Each stage is a set of P GEMMs,
// M[p] = V_p (pixel groups x 3C) * U_p (3C x C): 64 pixel groups x 64
// channels per round, 4x4 per thread, K in BK slices; V_p = B^T d is
// applied while a K slice is gathered into shared memory, the thread keeps
// all P accumulators, and the epilogue applies A^T. In f32 it is bound by
// operations (F(2,3): 14.5 GFLOP with the 12 C^2 form, 0.22 ms at 67
// TFLOP/s). What it leaves on the table: CUDA cores only; two barriers per
// K slice; U streamed from L2 for every slice of every round; each input
// gathered and transformed once per kw.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

// cudaFuncSetAttribute acts on the current device only, so a kernel's
// shared-memory limit is set once per device (bit d of `done` for device d),
// not once per process: a process that launches on a second card sets it
// there too
template <typename K>
cudaError_t smem_limit_once(std::atomic<unsigned long long>& done, K kernel, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidValue;
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

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

// ---- tensor-core path (bf16) ----

constexpr int kVLd = kC + 8;     // V's pixel stride in bf16: see kULd
// a slab row (the C inputs of one kw and output channel); C + 8 puts the 8
// rows of an ldmatrix phase in 8 distinct bank groups
constexpr int kULd = kC + 8;
constexpr int kTLd = kC + 4;     // t's pixel stride in f32
constexpr int kSlab = 3 * kC * kULd;  // one U_p slab, bf16 values
constexpr int kNFrag = kC / 16;  // 16-channel fragments of C

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Operands of mma.sync.m16n8k16 (bf16 x bf16 + f32), in the PTX ISA's
// register layouts; g = lane / 4, t = lane % 4. A, 16 pixels x 16 inputs:
// r[i] holds (pixel g + 8 (i % 2), inputs 8 (i / 2) + 2t, + 1). B, 16 inputs x
// 16 outputs: r[2h + i] holds (inputs 8i + 2t, + 1; output 8h + g). An
// accumulator, 16 pixels x 16 outputs: c[4h + 2e + i] is (pixel g + 8e,
// output 8h + 2t + i). All accumulators share that mapping, so A^T and the
// epilogue work element by element on the registers.
struct FragA {
  unsigned r[4];
};
struct FragB {
  unsigned r[4];
};
struct Acc {
  float c[8];
};

// ldmatrix.x4 from shared memory: lane l names row l % 8 of 8x8 matrix l / 8
// and receives, from each matrix i, elements (g, 2t) and (g, 2t + 1) in r[i]
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* row) {
#ifdef __CUDA_ARCH__
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
#elif !defined(__CUDACC__)
  emu_ldmatrix_x4(r, row);  // the CPU stand-in (ops/emulate.py)
#endif
}

// A operand: 16 pixels from p (stride ld) x inputs 0..15; matrix i covers
// pixels 8 (i % 2).., inputs 8 (i / 2)..
__device__ __forceinline__ void load_a(FragA& a, const __nv_bfloat16* p, int ld, int lane) {
  const int i = lane / 8;
  ldsm_x4(a.r, p + (lane % 8 + 8 * (i % 2)) * ld + 8 * (i / 2));
}

// B operand from a slab of rows of outputs (stride ld), inputs contiguous:
// matrix i covers outputs 8 (i / 2).., inputs 8 (i % 2)..
__device__ __forceinline__ void load_b(FragB& b, const __nv_bfloat16* p, int ld, int lane) {
  const int i = lane / 8;
  ldsm_x4(b.r, p + (lane % 8 + 8 * (i / 2)) * ld + 8 * (i % 2));
}

// acc += a x b, both 8-output halves
__device__ __forceinline__ void mma(Acc& acc, const FragA& a, const FragB& b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* d = acc.c + 4 * h;
#ifdef __CUDA_ARCH__
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[2 * h]),
          "r"(b.r[2 * h + 1]));
#elif !defined(__CUDACC__)
    emu_mma_m16n8k16(d, a.r, b.r[2 * h], b.r[2 * h + 1]);
#endif
  }
}

// A block's tile and its shared memory. Stage A makes t on TR x TC pixels
// (GA groups of M rows from one row above the tile, TC = TW + 2 columns from
// one column left of it) out of an x window of XR x XW pixels; stage B makes
// the TH x TW outputs. A warp's unit: MT M tiles (16 columns each) of one
// group row x NQ 16-channel fragments, P accumulators each; NW warps.
template <int M, int GB, int TW, int MT, int NQ, int NW>
struct TcTile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int P = M + 2;
  static constexpr int TH = GB * M;
  static constexpr int GA = GB + 1;
  static constexpr int TR = TH + 2;
  static constexpr int W = TW;
  static constexpr int TC = TW + 2;
  static constexpr int XR = GA * M + 2;
  static constexpr int XW = TC + 2;
  static constexpr int VWA = TC + 2;  // V columns: the last M tile reads up to col + 15 + 2
  static constexpr int VWB = TC;
  static constexpr int NFA = (TC + 15) / 16;  // M tiles of a group row
  static constexpr int NFB = (TW + 15) / 16;
  static constexpr int UNITS_A = GA * (NFA / MT) * (kNFrag / NQ);
  static constexpr int UNITS_B = GB * (NFB / MT) * (kNFrag / NQ);
  // t in f32; until stage A's epilogue the same bytes hold the x window, and
  // from stage B's products on the next tile's
  static constexpr int kTBytes = cmax(TR * TC * kTLd * 4, XR * XW * kC * 2);
  // V of either stage; in stage B the bytes past its V take the tile's
  // residual x
  static constexpr int kVBElems = P * GB * VWB * kVLd;
  static constexpr int kVBytes =
      cmax(P * GA * VWA * kVLd * 2, 2 * (kVBElems + TH * TW * kC)) + 127 & ~127;
  static constexpr int kUBytes = 2 * kSlab * 2;  // two slab buffers
  static constexpr int kBiasBytes = 2 * kC * 4;
  static constexpr int kSmemBytes = kTBytes + kVBytes + kUBytes + kBiasBytes;
  static_assert(TW >= 16 && kNFrag % NQ == 0, "tile geometry");
  static_assert(NFA % MT == 0 && NFB % MT == 0, "a unit's M tiles lie in one group row");
  static_assert(UNITS_A <= NW && UNITS_B <= NW, "one unit a warp per stage");
  static_assert(kTBytes % 128 == 0 && (kVBElems * 2) % 16 == 0, "16-byte aligned rows");
  static_assert(P % 2 == 0, "stage B's slabs alternate buffers as stage A's do");
};

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// the x window of the tile, XR x XW pixels from (h0 - 2, w0 - 2), 16 bytes
// (8 channels) per copy, zeros outside the image; a zero-filled copy reads
// nothing but still names a valid address
template <class Tl>
__device__ __forceinline__ void copy_x(__nv_bfloat16* xs, const __nv_bfloat16* __restrict__ xn,
                                       int h0, int w0, int h_img, int w_img) {
  for (int e = threadIdx.x; e < Tl::XR * Tl::XW * 8; e += Tl::kThreads) {
    const int q = e % 8;
    const int pix = e / 8;
    const int hh = h0 - 2 + pix / Tl::XW;
    const int ww = w0 - 2 + pix % Tl::XW;
    const bool inside = hh >= 0 && hh < h_img && ww >= 0 && ww < w_img;
    const __nv_bfloat16* src = inside ? xn + ((long long)hh * w_img + ww) * kC + 8 * q : xn;
    __pipeline_memcpy_async(xs + pix * kC + 8 * q, src, 16, inside ? 0 : 16);
  }
}

// the tile's own TH x TW pixels of x, for the residual add. A pixel's 16-byte
// chunk q sits at chunk q ^ (pixel % 8), so that the epilogue's lanes, 8
// pixels apart, read distinct banks.
__device__ __forceinline__ int res_at(int pix, int ch) {
  return pix * kC + ((ch / 8) ^ (pix % 8)) * 8 + ch % 8;
}

template <class Tl>
__device__ __forceinline__ void copy_residual(__nv_bfloat16* rs,
                                              const __nv_bfloat16* __restrict__ xn, int h0,
                                              int w0, int h_img, int w_img) {
  for (int e = threadIdx.x; e < Tl::TH * Tl::W * 8; e += Tl::kThreads) {
    const int q = e % 8;
    const int pix = e / 8;
    const int hh = h0 + pix / Tl::W;
    const int ww = w0 + pix % Tl::W;
    const bool inside = hh < h_img && ww < w_img;
    const __nv_bfloat16* src = inside ? xn + ((long long)hh * w_img + ww) * kC + 8 * q : xn;
    __pipeline_memcpy_async(rs + res_at(pix, 8 * q), src, 16, inside ? 0 : 16);
  }
}

// one U_p slab, [kw][co][ci] in the transposed basis, into rows of kULd
template <int kThreads>
__device__ __forceinline__ void copy_slab(__nv_bfloat16* slab,
                                          const __nv_bfloat16* __restrict__ u_p) {
  for (int e = threadIdx.x; e < 3 * kC * 8; e += kThreads) {
    const int row = e / 8;
    const int q = e % 8;
    __pipeline_memcpy_async(slab + row * kULd + 8 * q, u_p + row * kC + 8 * q, 16);
  }
}

// V_p = B^T d for 8 channels of one group row and column: d holds the
// group's P input rows in f32; writes P x 16 bytes, rounded once to bf16
template <int M>
__device__ __forceinline__ void store_v(const float (&d)[M + 2][8], __nv_bfloat16* v,
                                        int p_stride) {
  constexpr int P = M + 2;
  float vv[P][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float col[P], out[P];
#pragma unroll
    for (int j = 0; j < P; ++j) col[j] = d[j][i];
    Wino<M>::bt(col, out);
#pragma unroll
    for (int p = 0; p < P; ++p) vv[p][i] = out[p];
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    *reinterpret_cast<uint4*>(v + p * p_stride) =
        make_uint4(pack_bf16(vv[p][0], vv[p][1]), pack_bf16(vv[p][2], vv[p][3]),
                   pack_bf16(vv[p][4], vv[p][5]), pack_bf16(vv[p][6], vv[p][7]));
}

// V of a stage, [P][GR][VW][kVLd], from a source of f32 or bf16 pixels with
// kPixLd values a pixel and SW pixels a row: item (g, c, 8 channels) reads
// the group's P rows. kIlp items a thread at a time, all loaded before any
// is stored (2 within 8 warps' registers; 1 with more warps, which spill
// at 2).
template <int M, int GR, int VW, int SW, int kPixLd, int kThreads, typename S>
__device__ __forceinline__ void transform(const S* src, __nv_bfloat16* vs) {
  constexpr int kItems = GR * VW * 8;
  constexpr int kIlp = kThreads > 256 ? 1 : 2;
  for (int e0 = threadIdx.x; e0 < kItems; e0 += kIlp * kThreads) {
    float d[kIlp][M + 2][8];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int e = e0 + k * kThreads;
      const int q = e % 8;
      const int c = (e / 8) % VW;
      const int g = e / (8 * VW);
#pragma unroll
      for (int j = 0; j < M + 2; ++j) {
        if (e >= kItems) continue;
        const S* px = src + ((g * M + j) * SW + c) * kPixLd + 8 * q;
        if constexpr (std::is_same<S, float>::value) {
          const float4 lo = *reinterpret_cast<const float4*>(px);
          const float4 hi = *reinterpret_cast<const float4*>(px + 4);
          d[k][j][0] = lo.x, d[k][j][1] = lo.y, d[k][j][2] = lo.z, d[k][j][3] = lo.w;
          d[k][j][4] = hi.x, d[k][j][5] = hi.y, d[k][j][6] = hi.z, d[k][j][7] = hi.w;
        } else {
          const uint4 raw = *reinterpret_cast<const uint4*>(px);
          const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d[k][j][2 * i] = bf16_lo(w[i]);
            d[k][j][2 * i + 1] = bf16_hi(w[i]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int e = e0 + k * kThreads;
      if (e >= kItems) continue;
      const int q = e % 8;
      const int c = (e / 8) % VW;
      const int g = e / (8 * VW);
      store_v<M>(d[k], vs + (g * VW + c) * kVLd + 8 * q, GR * VW * kVLd);
    }
  }
}

// A warp's unit in a stage of GR group rows, NF M tiles a row and COLS
// output columns: its group row, its MT M tiles' first columns (the last M
// tile of a row ends at COLS and may overlap the one before) and first
// columns written (columns the tile before has written are skipped), and
// its first fragment
template <int GR, int NF, int COLS, int MT, int NQ>
struct Unit {
  int gr, col[MT], first[MT], nq0;
  bool live;
  __device__ explicit Unit(int warp) {
    constexpr int per_group = kNFrag / NQ;
    const int mg = warp / per_group;
    live = mg < GR * (NF / MT);
    gr = mg / (NF / MT);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int cf = mg % (NF / MT) * MT + i;
      col[i] = cf == NF - 1 ? COLS - 16 : 16 * cf;
      first[i] = 16 * cf;
    }
    nq0 = (warp % per_group) * NQ;
  }
};

// The P point-product steps of a stage: at step p the slab U_p sits in
// buffer (s0 + p) % 2 while the next slab (U_{p+1}, or `u_next`'s U_0 after
// the last p) is copied into the other. With kHead, `head` commits one more
// group of copies at step 0, which may stay in flight until step 2. M_p =
// sum over kw and the C inputs of V_p (16 columns shifted by kw) x U_p[kw]:
// an A operand is read at the kw shift straight from V, so each transformed
// value serves three taps. Accumulator i * NQ + j is M tile i x fragment j.
// Ends with every copy landed and every warp done.
template <int P, int MT, int NQ, int VW, bool kHead, int kThreads, class U, class Head>
__device__ __forceinline__ void point_products(Acc (&acc)[P][MT * NQ], const U& unit,
                                               int gr_count,
                                               const __nv_bfloat16* vs, __nv_bfloat16* us,
                                               int s0, const __nv_bfloat16* __restrict__ u,
                                               const __nv_bfloat16* __restrict__ u_next,
                                               int lane, Head head) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < MT * NQ; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[p][q].c[e] = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (kHead && p == 1) {
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // slab p landed for every thread; the other buffer is free
    copy_slab<kThreads>(us + ((s0 + p + 1) % 2) * kSlab,
                        p + 1 < P ? u + (p + 1) * 3 * kC * kC : u_next);
    __pipeline_commit();
    if (kHead && p == 0) {
      head();
      __pipeline_commit();
    }
    if (unit.live) {
      const __nv_bfloat16* v = vs + (p * gr_count + unit.gr) * VW * kVLd;
      const __nv_bfloat16* slab = us + ((s0 + p) % 2) * kSlab + 16 * unit.nq0 * kULd;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks) {
          FragA a[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            load_a(a[i], v + (unit.col[i] + kw) * kVLd + 16 * ks, kVLd, lane);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            FragB b;
            load_b(b, slab + (kw * kC + 16 * j) * kULd + 16 * ks, kULd, lane);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma(acc[p][i * NQ + j], a[i], b);
          }
        }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every warp's products are done: V may be reused
}

// A^T across the P accumulators of tile j, element by element: output row
// r lands in acc[r][j] (A: Acc, or the f32 path's n8 tile Acc4)
template <int M, int NT, class A>
__device__ __forceinline__ void apply_at(A (&acc)[M + 2][NT], int j) {
#pragma unroll
  for (int e = 0; e < (int)(sizeof(A::c) / sizeof(float)); ++e) {
    float mv[M + 2], yv[M];
#pragma unroll
    for (int p = 0; p < M + 2; ++p) mv[p] = acc[p][j].c[e];
    Wino<M>::at(mv, yv);
#pragma unroll
    for (int r = 0; r < M; ++r) acc[r][j].c[e] = yv[r];
  }
}

struct TcShape {
  int h_img, w_img, h_tiles, w_tiles, n_tiles;
};

// the element offset of a tile's image in x and y, and its corner
template <class Tl>
__device__ __forceinline__ long long tile_origin(const TcShape& s, int tile, int& h0, int& w0) {
  const int rest = tile / s.w_tiles;
  w0 = (tile % s.w_tiles) * Tl::W;
  h0 = (rest % s.h_tiles) * Tl::TH;
  return (long long)(rest / s.h_tiles) * s.h_img * s.w_img * kC;
}

// The persistent launch of a tensor-core kernel over tile geometry Tl:
// refuses an empty frame (cudaErrorInvalidValue) and x, ua, ub or y not
// 16-byte aligned (cudaErrorMisalignedAddress, for the 16-byte copies)
// before launching anything, then runs as many blocks as the SMs hold, at
// most one a tile. `attr` is the kernel's shared-memory opt-in.
template <class Tl, typename T, class K>
int launch_persistent(K kernel, cudaError_t attr, const T* x, const T* ua, const void* ba,
                      const T* ub, const void* bb, T* y, float rw, int n, int h, int w,
                      void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(ua) |
       reinterpret_cast<std::uintptr_t>(ub) | reinterpret_cast<std::uintptr_t>(y)) % 16)
    return cudaErrorMisalignedAddress;
  if (attr != cudaSuccess) return (int)attr;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Tl::kThreads,
                                                        Tl::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int h_tiles = (h + Tl::TH - 1) / Tl::TH;
  const int w_tiles = (w + Tl::W - 1) / Tl::W;
  const long long n_tiles = (long long)n * h_tiles * w_tiles;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const TcShape s{h, w, h_tiles, w_tiles, (int)n_tiles};
  const long long blocks = (long long)sms * per_sm < n_tiles ? (long long)sms * per_sm : n_tiles;
  kernel<<<(unsigned)blocks, Tl::kThreads, Tl::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, ua, static_cast<const float*>(ba), ub, static_cast<const float*>(bb), y, rw, s);
  return (int)cudaGetLastError();
}

// Persistent: block b walks the tiles b, b + gridDim.x, ... Per tile:
// stage A (x -> t in shared memory), stage B (t -> y). During stage B's
// products the next tile's x window (into t's bytes, read by then) and
// this tile's residual are copied, and its last step copies the next
// tile's first slab.
template <int M, int GB, int TW, int MT, int NQ, int NW>
__global__ void __launch_bounds__(32 * NW)
    wino_resblock_tc_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ ua,
                            const float* __restrict__ ba,
                            const __nv_bfloat16* __restrict__ ub,
                            const float* __restrict__ bb, __nv_bfloat16* __restrict__ y,
                            float rw, TcShape s) {
  using Tl = TcTile<M, GB, TW, MT, NQ, NW>;
  constexpr int P = Tl::P;
  constexpr int kThreads = Tl::kThreads;
  extern __shared__ __align__(128) float4 tc_smem[];
  char* const base = reinterpret_cast<char*>(tc_smem);
  float* const ts = reinterpret_cast<float*>(base);                  // [TR][TC][kTLd] t
  __nv_bfloat16* const xs = reinterpret_cast<__nv_bfloat16*>(base);  // [XR][XW][C] x window
  __nv_bfloat16* const vs = reinterpret_cast<__nv_bfloat16*>(base + Tl::kTBytes);
  __nv_bfloat16* const rs = vs + Tl::kVBElems;  // [TH][TW][C] residual, in stage B
  __nv_bfloat16* const us =
      reinterpret_cast<__nv_bfloat16*>(base + Tl::kTBytes + Tl::kVBytes);
  float* const bias = reinterpret_cast<float*>(base + Tl::kTBytes + Tl::kVBytes + Tl::kUBytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // an accumulator's pixels g, g + 8 and outputs 2t, 2t + 1
  const int t2 = 2 * (lane % 4);
  for (int i = threadIdx.x; i < 2 * kC; i += kThreads) bias[i] = i < kC ? ba[i] : bb[i - kC];

  {
    int h0, w0;
    const long long off = tile_origin<Tl>(s, blockIdx.x, h0, w0);
    copy_x<Tl>(xs, x + off, h0, w0, s.h_img, s.w_img);
    copy_slab<kThreads>(us, ua);
    __pipeline_commit();
  }
  for (int tile = blockIdx.x; tile < s.n_tiles; tile += gridDim.x) {
    int h0, w0;
    const long long off = tile_origin<Tl>(s, tile, h0, w0);
    const __nv_bfloat16* const xn = x + off;
    __nv_bfloat16* const yn = y + off;

    __pipeline_wait_prior(0);
    __syncthreads();  // the x window and U_0 landed; the last tile's buffers are free
    transform<M, Tl::GA, Tl::VWA, Tl::XW, kC, kThreads>(xs, vs);

    {  // stage A: t = ReLU(conv_a(x) + b_a) on the window, 0 outside the image
      const Unit<Tl::GA, Tl::NFA, Tl::TC, MT, NQ> unit(warp);
      Acc acc[P][MT * NQ];
      point_products<P, MT, NQ, Tl::VWA, false, kThreads>(acc, unit, Tl::GA, vs, us, 0, ua, ub,
                                                           lane, [] {});
      if (unit.live) {
#pragma unroll
        for (int q = 0; q < MT * NQ; ++q) {
          apply_at<M, MT * NQ>(acc, q);
          const int i = q / NQ;
#pragma unroll
          for (int r = 0; r < M; ++r) {
            const int tr = unit.gr * M + r;  // t-local row: global h0 - 1 + tr
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int tc = unit.col[i] + g + 8 * e;
              if (tr >= Tl::TR || tc < unit.first[i]) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int co = 16 * (unit.nq0 + q % NQ) + 8 * h + t2;
                const float* c = acc[r][q].c + 4 * h + 2 * e;
                *reinterpret_cast<float2*>(ts + (tr * Tl::TC + tc) * kTLd + co) =
                    make_float2(fmaxf(c[0] + bias[co], 0.f), fmaxf(c[1] + bias[co + 1], 0.f));
              }
            }
          }
        }
      }
    }
    __syncthreads();  // t is whole
    // t outside the image is 0, not ReLU(b_a): conv_b's SAME padding. Only
    // a tile whose window crosses the image's edge has such pixels.
    if (h0 < 1 || w0 < 1 || h0 + Tl::TH >= s.h_img || w0 + TW >= s.w_img) {
      for (int e = threadIdx.x; e < Tl::TR * Tl::TC * (kC / 4); e += kThreads) {
        const int pix = e / (kC / 4);
        const int gh = h0 - 1 + pix / Tl::TC;
        const int gw = w0 - 1 + pix % Tl::TC;
        if (gh < 0 || gh >= s.h_img || gw < 0 || gw >= s.w_img)
          *reinterpret_cast<float4*>(ts + pix * kTLd + 4 * (e % (kC / 4))) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
    }
    transform<M, GB, Tl::VWB, Tl::TC, kTLd, kThreads>(ts, vs);

    {  // stage B: y = x + rw * (conv_b(t) + b_b)
      const Unit<GB, Tl::NFB, TW, MT, NQ> unit(warp);
      Acc acc[P][MT * NQ];
      const int next = tile + gridDim.x;
      auto head = [&] {  // the next tile's x window, into t's bytes, and the residual
        if (next < s.n_tiles) {
          int h1, w1;
          const long long off1 = tile_origin<Tl>(s, next, h1, w1);
          copy_x<Tl>(xs, x + off1, h1, w1, s.h_img, s.w_img);
        }
        copy_residual<Tl>(rs, xn, h0, w0, s.h_img, s.w_img);
      };
      point_products<P, MT, NQ, Tl::VWB, true, kThreads>(acc, unit, GB, vs, us, P, ub, ua,
                                                          lane, head);
      if (unit.live) {
#pragma unroll
        for (int q = 0; q < MT * NQ; ++q) {
          apply_at<M, MT * NQ>(acc, q);
          const int i = q / NQ;
#pragma unroll
          for (int r = 0; r < M; ++r) {
            const int lr = unit.gr * M + r;  // tile-local output row and column
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int lc = unit.col[i] + g + 8 * e;
              if (h0 + lr >= s.h_img || w0 + lc >= s.w_img || lc < unit.first[i]) continue;
              const long long pix = (long long)(h0 + lr) * s.w_img + w0 + lc;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int co = kC + 16 * (unit.nq0 + q % NQ) + 8 * h + t2;  // in bias: b_b
                const float* c = acc[r][q].c + 4 * h + 2 * e;
                const unsigned xr =
                    *reinterpret_cast<const unsigned*>(rs + res_at(lr * TW + lc, co - kC));
                *reinterpret_cast<unsigned*>(yn + pix * kC + co - kC) =
                    pack_bf16(bf16_lo(xr) + (c[0] + bias[co]) * rw,
                              bf16_hi(xr) + (c[1] + bias[co + 1]) * rw);
              }
            }
          }
        }
      }
    }
  }
}

template <int M, int GB, int TW, int MT, int NQ, int NW>
int launch_tc(const void* x, const void* ua, const void* ba, const void* ub, const void* bb,
              void* y, float rw, int n, int h, int w, void* stream) {
  using Tl = TcTile<M, GB, TW, MT, NQ, NW>;
  auto kernel = wino_resblock_tc_kernel<M, GB, TW, MT, NQ, NW>;
  // once per process and instance: the tile's shared memory exceeds 48 KB
  static std::atomic<unsigned long long> limit_set{0};
  const cudaError_t attr = smem_limit_once(limit_set, kernel, Tl::kSmemBytes);
  return launch_persistent<Tl>(kernel, attr, static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(ua), ba,
                               static_cast<const __nv_bfloat16*>(ub), bb,
                               static_cast<__nv_bfloat16*>(y), rw, n, h, w, stream);
}

// ---- tensor-core path (f32): split TF32 ----

// mma.sync.m16n8k8 tf32 operands in the PTX ISA's register layouts, g =
// lane / 4, t = lane % 4. A, 16 pixels x 8 inputs: a[0] (pixel g, input t),
// a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4). B, 8 inputs x 8
// outputs: b0 (input t, output g), b1 (t + 4, g). D, 16 pixels x 8
// outputs: d[2e + i] is (pixel g + 8e, output 2t + i). Every accumulator
// has that mapping, so A^T and the epilogues work element by element.

// an accumulator n8 tile: d[2e + i] above
struct Acc4 {
  float c[4];
};

// ldmatrix.x4 read as 8 rows of 4 floats a matrix: matrix i hands lane l
// the float (g, t), the tf32 fragment element above
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* row) {
#ifdef __CUDA_ARCH__
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
#elif !defined(__CUDACC__)
  emu_ldmatrix_x4(r, row);  // the CPU stand-in (ops/emulate.py)
#endif
}

// cvt.rna.tf32.f32: v rounded to 10 explicit mantissa bits, ties away from
// zero, low 13 bits zero. The tensor core reads a .tf32 operand by ignoring
// those 13 bits, so an operand that skipped this would be truncated.
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

// The f32 block's tile and shared memory, with the geometry of TcTile: the
// x window in f32 (pixel stride C) and t (pixel stride kTLd) share their
// bytes, since t is written only after stage A's last product; one basis
// tap V_p of either stage (pixel stride kTLd); a ring of two (p, kw) weight
// slabs, each the tap's hi rows then its lo rows (kTLd floats a row).
template <int M, int GB, int TW, int MT, int NQ, int NW>
struct F32Tile : TcTile<M, GB, TW, MT, NQ, NW> {
  using G = TcTile<M, GB, TW, MT, NQ, NW>;
  static constexpr int kMT = MT, kNQ = NQ;
  static constexpr int NT = MT * 2 * NQ;  // a warp's n8 accumulator tiles per basis tap
  static constexpr int kBasisFloats = G::P * 3 * kC * kC;  // hi to lo in the split basis
  static constexpr int kSlabFloats = 2 * kC * kTLd;
  static constexpr int kXFloats = cmax(G::TR * G::TC * kTLd, G::XR * G::XW * kC);
  static constexpr int kVFloats = cmax(G::GA * G::VWA, GB * G::VWB) * kTLd + 31 & ~31;
  static constexpr int kSmemBytes = 4 * (kXFloats + kVFloats + 2 * kSlabFloats + 2 * kC);
  static_assert(kXFloats % 32 == 0 && kVFloats % 32 == 0, "128-byte aligned regions");
};

// the f32 x window, XR x XW pixels from (h0 - 2, w0 - 2), 4 channels a copy,
// zeros outside the image
template <class Tl>
__device__ __forceinline__ void copy_x_f32(float* xs, const float* __restrict__ xn, int h0,
                                           int w0, int h_img, int w_img) {
  for (int e = threadIdx.x; e < Tl::XR * Tl::XW * (kC / 4); e += Tl::kThreads) {
    const int q = e % (kC / 4);
    const int pix = e / (kC / 4);
    const int hh = h0 - 2 + pix / Tl::XW;
    const int ww = w0 - 2 + pix % Tl::XW;
    const bool inside = hh >= 0 && hh < h_img && ww >= 0 && ww < w_img;
    const float* src = inside ? xn + ((long long)hh * w_img + ww) * kC + 4 * q : xn;
    __pipeline_memcpy_async(xs + pix * kC + 4 * q, src, 16, inside ? 0 : 16);
  }
}

// weight slab `tap` (= 3 p + kw) of a split basis u, hi (P, 3, C_out, C_in)
// with lo kBasisFloats after it, into a ring buffer: hi rows, then lo rows
template <class Tl>
__device__ __forceinline__ void copy_tap(float* slab, const float* __restrict__ u, int tap) {
  for (int e = threadIdx.x; e < 2 * kC * (kC / 4); e += Tl::kThreads) {
    const int row = e / (kC / 4);  // part * C + output channel
    const int q = e % (kC / 4);
    const int part = row / kC;
    __pipeline_memcpy_async(slab + row * kTLd + 4 * q,
                            u + part * Tl::kBasisFloats + (tap * kC + row % kC) * kC + 4 * q,
                            16);
  }
}

// V_p = row p of B^T d, [GR][VW][kTLd], from a source of f32 pixels with
// kPixLd floats a pixel and SW pixels a row: item (g, c, 4 channels) reads
// the rows of group g that B^T's row p names (the others are never loaded
// once p is a constant of the unrolled caller)
template <int M, int GR, int VW, int SW, int kPixLd, int kThreads>
__device__ __forceinline__ void transform_row(int p, const float* src, float* vs) {
  constexpr int kItems = GR * VW * (kC / 4);
  for (int e = threadIdx.x; e < kItems; e += kThreads) {
    const int q = e % (kC / 4);
    const int c = (e / (kC / 4)) % VW;
    const int g = e / ((kC / 4) * VW);
    const float* px = src + (g * M * SW + c) * kPixLd + 4 * q;
    float d[4][M + 2];
#pragma unroll
    for (int j = 0; j < M + 2; ++j) {
      const float4 f = *reinterpret_cast<const float4*>(px + j * SW * kPixLd);
      d[0][j] = f.x, d[1][j] = f.y, d[2][j] = f.z, d[3][j] = f.w;
    }
    float v[4][M + 2];
#pragma unroll
    for (int i = 0; i < 4; ++i) Wino<M>::bt(d[i], v[i]);
    *reinterpret_cast<float4*>(vs + (g * VW + c) * kTLd + 4 * q) =
        make_float4(v[0][p], v[1][p], v[2][p], v[3][p]);
  }
}

// One (p, kw) step of a warp's unit: M_p += V_p (its MT M tiles, shifted by
// kw columns) x U_p[kw] (its NQ 16-channel fragments), in split TF32. Per
// k-step the A operands are loaded and split once for all the unit's n8
// tiles, and each accumulator takes lo x hi, hi x lo, then hi x hi.
// Accumulator i * 2 NQ + n is M tile i x n8 tile n.
template <int MT, int NQ, class U>
__device__ __forceinline__ void products_f32(Acc4 (&acc)[MT * 2 * NQ], const U& unit,
                                             const float* v_row, const float* slab, int kw,
                                             int lane) {
  const int mi = lane / 8;  // the ldmatrix matrix this lane names a row of
  // A: pixel lane % 8 + 8 (mi % 2), inputs 4 (mi / 2)..; B: output lane % 8
  // + 8 (mi / 2) of a fragment, inputs 4 (mi % 2)..
  const float* a_p[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    a_p[i] = v_row + (unit.col[i] + kw + lane % 8 + 8 * (mi % 2)) * kTLd + 4 * (mi / 2);
  const float* b_hi = slab + (16 * unit.nq0 + lane % 8 + 8 * (mi / 2)) * kTLd + 4 * (mi % 2);
  const float* b_lo = b_hi + kC * kTLd;
#pragma unroll
  for (int k0 = 0; k0 < kC; k0 += 8) {
    unsigned a_hi[MT][4], a_lo[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned raw[4];
      ldsm_x4(raw, a_p[i] + k0);
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(a_hi[i][r], a_lo[i][r], raw[r]);
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      // r[2h], r[2h + 1]: b0, b1 of n8 tile 2 j + h
      unsigned bh[4], bl[4];
      ldsm_x4(bh, b_hi + 16 * j * kTLd + k0);
      ldsm_x4(bl, b_lo + 16 * j * kTLd + k0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_tf32(acc[i * 2 * NQ + 2 * j + h].c, a_lo[i], bh[2 * h], bh[2 * h + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_tf32(acc[i * 2 * NQ + 2 * j + h].c, a_hi[i], bl[2 * h], bl[2 * h + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_tf32(acc[i * 2 * NQ + 2 * j + h].c, a_hi[i], bh[2 * h], bh[2 * h + 1]);
    }
  }
}

// The point products of a stage on GR group rows, V built one basis tap at
// a time: at tap p the block transforms V_p from `src` (SW pixels a row,
// kPixLd floats a pixel) into vs, then runs the three kw steps of slab s =
// 3 p + kw, which sits in ring buffer s % 2 while slab s + 1 (after the
// last, slab 0 of `u_next`) is copied into the other. `head` issues one
// more group of copies at the last step. Called after a barrier that made
// `src` whole and freed vs; returns with every warp's last products issued
// but not waited for.
template <int M, int GR, int VW, int SW, int kPixLd, class Tl, class U, class Head>
__device__ __forceinline__ void stage_f32(Acc4 (&acc)[M + 2][Tl::NT], const U& unit,
                                          const float* src, float* vs, float* ring,
                                          const float* __restrict__ u,
                                          const float* __restrict__ u_next, int lane,
                                          Head head) {
  constexpr int P = M + 2;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < Tl::NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][q].c[e] = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p > 0) __syncthreads();  // every warp is done with V_{p-1}
    transform_row<M, GR, VW, SW, kPixLd, Tl::kThreads>(p, src, vs);
#pragma unroll 1
    for (int kw = 0; kw < 3; ++kw) {
      const int s = 3 * p + kw;
      __pipeline_wait_prior(0);
      __syncthreads();  // slab s landed; V_p is whole; the other buffer is free
      copy_tap<Tl>(ring + (s + 1) % 2 * Tl::kSlabFloats, s + 1 < 3 * P ? u : u_next,
                   s + 1 < 3 * P ? s + 1 : 0);
      __pipeline_commit();
      if (s == 3 * P - 1) {
        head();
        __pipeline_commit();
      }
      if (unit.live)
        products_f32<Tl::kMT, Tl::kNQ>(acc[p], unit, vs + unit.gr * VW * kTLd,
                                       ring + s % 2 * Tl::kSlabFloats, kw, lane);
    }
  }
}

// Persistent, as the bf16 kernel: per tile, stage A (x -> t in shared
// memory), stage B (t -> y). The next tile's x window is copied into t's
// bytes from stage B's last step on, once its last V_p has been read off
// t; the residual comes from global memory in the epilogue (the tile's x
// window was read moments before, so it sits in L2).
template <int M, int GB, int TW, int MT, int NQ, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
    wino_resblock_f32_tc_kernel(const float* __restrict__ x, const float* __restrict__ ua,
                                const float* __restrict__ ba, const float* __restrict__ ub,
                                const float* __restrict__ bb, float* __restrict__ y, float rw,
                                TcShape s) {
  using Tl = F32Tile<M, GB, TW, MT, NQ, NW>;
  constexpr int P = Tl::P;
  constexpr int NT = Tl::NT;
  extern __shared__ __align__(128) float4 f32_smem[];
  float* const xs = reinterpret_cast<float*>(f32_smem);  // [XR][XW][C] x window
  float* const ts = xs;                                   // after stage A: [TR][TC][kTLd] t
  float* const vs = xs + Tl::kXFloats;                    // [GR][VW][kTLd] V_p
  float* const ring = vs + Tl::kVFloats;                  // [2][hi, lo][C][kTLd] slabs
  float* const bias = ring + 2 * Tl::kSlabFloats;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // an accumulator's pixels g, g + 8 and outputs 2t, 2t + 1
  const int t2 = 2 * (lane % 4);
  for (int i = threadIdx.x; i < 2 * kC; i += Tl::kThreads) bias[i] = i < kC ? ba[i] : bb[i - kC];

  {
    int h0, w0;
    const long long off = tile_origin<Tl>(s, blockIdx.x, h0, w0);
    copy_x_f32<Tl>(xs, x + off, h0, w0, s.h_img, s.w_img);
    copy_tap<Tl>(ring, ua, 0);
    __pipeline_commit();
  }
  for (int tile = blockIdx.x; tile < s.n_tiles; tile += gridDim.x) {
    int h0, w0;
    const long long off = tile_origin<Tl>(s, tile, h0, w0);
    const float* const xn = x + off;
    float* const yn = y + off;

    __pipeline_wait_prior(0);
    __syncthreads();  // the x window and the first slab landed; the last tile's V is free

    {  // stage A: t = ReLU(conv_a(x) + b_a) on the window, 0 outside the image
      const Unit<Tl::GA, Tl::NFA, Tl::TC, MT, NQ> unit(warp);
      Acc4 acc[P][NT];
      stage_f32<M, Tl::GA, Tl::VWA, Tl::XW, kC, Tl>(acc, unit, xs, vs, ring, ua, ub, lane,
                                                     [] {});
      __syncthreads();  // every warp's products are done: the x window's bytes take t
      if (unit.live) {
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          apply_at<M, NT>(acc, q);
          const int i = q / (2 * NQ);
          const int co = 16 * unit.nq0 + 8 * (q % (2 * NQ)) + t2;
#pragma unroll
          for (int r = 0; r < M; ++r) {
            const int tr = unit.gr * M + r;  // t-local row: global h0 - 1 + tr
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int tc = unit.col[i] + g + 8 * e;
              if (tr >= Tl::TR || tc < unit.first[i]) continue;
              *reinterpret_cast<float2*>(ts + (tr * Tl::TC + tc) * kTLd + co) =
                  make_float2(fmaxf(acc[r][q].c[2 * e] + bias[co], 0.f),
                              fmaxf(acc[r][q].c[2 * e + 1] + bias[co + 1], 0.f));
            }
          }
        }
      }
    }
    __syncthreads();  // t is whole
    // t outside the image is 0, not ReLU(b_a): conv_b's SAME padding
    if (h0 < 1 || w0 < 1 || h0 + Tl::TH >= s.h_img || w0 + TW >= s.w_img) {
      for (int e = threadIdx.x; e < Tl::TR * Tl::TC * (kC / 4); e += Tl::kThreads) {
        const int pix = e / (kC / 4);
        const int gh = h0 - 1 + pix / Tl::TC;
        const int gw = w0 - 1 + pix % Tl::TC;
        if (gh < 0 || gh >= s.h_img || gw < 0 || gw >= s.w_img)
          *reinterpret_cast<float4*>(ts + pix * kTLd + 4 * (e % (kC / 4))) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
    }

    {  // stage B: y = x + rw * (conv_b(t) + b_b)
      const Unit<GB, Tl::NFB, TW, MT, NQ> unit(warp);
      Acc4 acc[P][NT];
      const int next = tile + gridDim.x;
      auto next_x = [&] {  // t's last V_p is built: its bytes take the next x window
        if (next < s.n_tiles) {
          int h1, w1;
          const long long off1 = tile_origin<Tl>(s, next, h1, w1);
          copy_x_f32<Tl>(xs, x + off1, h1, w1, s.h_img, s.w_img);
        }
      };
      stage_f32<M, GB, Tl::VWB, Tl::TC, kTLd, Tl>(acc, unit, ts, vs, ring, ub, ua, lane, next_x);
      if (unit.live) {
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          apply_at<M, NT>(acc, q);
          const int i = q / (2 * NQ);
          const int co = 16 * unit.nq0 + 8 * (q % (2 * NQ)) + t2;
#pragma unroll
          for (int r = 0; r < M; ++r) {
            const int lr = unit.gr * M + r;  // tile-local output row and column
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int lc = unit.col[i] + g + 8 * e;
              if (h0 + lr >= s.h_img || w0 + lc >= s.w_img || lc < unit.first[i]) continue;
              const long long at = ((long long)(h0 + lr) * s.w_img + w0 + lc) * kC + co;
              const float2 xr = *reinterpret_cast<const float2*>(xn + at);
              *reinterpret_cast<float2*>(yn + at) =
                  make_float2(xr.x + (acc[r][q].c[2 * e] + bias[kC + co]) * rw,
                              xr.y + (acc[r][q].c[2 * e + 1] + bias[kC + co + 1]) * rw);
            }
          }
        }
      }
    }
  }
}

template <int M, int GB, int TW, int MT, int NQ, int NW>
int launch_f32_tc(const void* x, const void* ua, const void* ba, const void* ub, const void* bb,
                  void* y, float rw, int n, int h, int w, void* stream) {
  using Tl = F32Tile<M, GB, TW, MT, NQ, NW>;
  auto kernel = wino_resblock_f32_tc_kernel<M, GB, TW, MT, NQ, NW>;
  // once per process and instance: the tile's shared memory exceeds 48 KB
  static std::atomic<unsigned long long> limit_set{0};
  const cudaError_t attr = smem_limit_once(limit_set, kernel, Tl::kSmemBytes);
  return launch_persistent<Tl>(kernel, attr, static_cast<const float*>(x),
                               static_cast<const float*>(ua), ba, static_cast<const float*>(ub),
                               bb, static_cast<float*>(y), rw, n, h, w, stream);
}

// Tensor-core tiles, 30 output columns (stage A's t window 32 columns: two
// M tiles; stage B's 30 in two overlapping ones). F(2,3): 6 x 30 outputs, 8
// warps, a warp's unit both M tiles of a group row x 32 channels (8 units
// in stage A, 6 in B). F(4,3): 8 x 30 outputs, 12 warps, units of both M
// tiles x 16 channels (12 in stage A, 8 in B). The f32 entries take the
// same tiles with 16-channel units: F(2,3) on 16 warps (16 units in stage
// A, 12 in B), F(4,3) on 12.
constexpr int kTcWidth = 30;
constexpr int kF2TcGroups = 3, kF2TcTiles = 2, kF2TcNq = 2, kF2TcWarps = 8;
constexpr int kF4TcGroups = 2, kF4TcTiles = 2, kF4TcNq = 1, kF4TcWarps = 12;
constexpr int kF2F32Nq = 1, kF2F32Warps = 16;
constexpr int kF4F32Nq = 1, kF4F32Warps = 12;

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

// bf16 on the tensor cores, same arguments as the entries above except the
// weights: ua, ub (m + 2, 3, 64, 64) with the channel axes swapped, U[p, kw,
// co, ci] (ops/wino_resblock.py `entry_basis`). x, ua, ub and y must be
// 16-byte aligned (cudaErrorMisalignedAddress otherwise) and n, h, w
// positive (cudaErrorInvalidValue), with nothing launched.
extern "C" int wino_resblock_f2_bf16_tc(const void* x, const void* ua, const void* ba,
                                        const void* ub, const void* bb, void* y, float rw, int n,
                                        int h, int w, void* stream) {
  return launch_tc<2, kF2TcGroups, kTcWidth, kF2TcTiles, kF2TcNq, kF2TcWarps>(
      x, ua, ba, ub, bb, y, rw, n, h, w, stream);
}

extern "C" int wino_resblock_f4_bf16_tc(const void* x, const void* ua, const void* ba,
                                        const void* ub, const void* bb, void* y, float rw, int n,
                                        int h, int w, void* stream) {
  return launch_tc<4, kF4TcGroups, kTcWidth, kF4TcTiles, kF4TcNq, kF4TcWarps>(
      x, ua, ba, ub, bb, y, rw, n, h, w, stream);
}

// f32 on the tensor cores in split TF32, same arguments as the entries above
// except the weights: ua, ub each point at the basis's tf32 parts, hi then
// lo, each (m + 2, 3, 64, 64) with the channel axes swapped, U[p, kw, co,
// ci] (ops/wino_resblock.py `entry_basis`, which keeps the exact basis in
// front of them). Refusals as for the bf16 entries.
extern "C" int wino_resblock_f2_f32_tc(const void* x, const void* ua, const void* ba,
                                       const void* ub, const void* bb, void* y, float rw, int n,
                                       int h, int w, void* stream) {
  return launch_f32_tc<2, kF2TcGroups, kTcWidth, kF2TcTiles, kF2F32Nq, kF2F32Warps>(
      x, ua, ba, ub, bb, y, rw, n, h, w, stream);
}

extern "C" int wino_resblock_f4_f32_tc(const void* x, const void* ua, const void* ba,
                                       const void* ub, const void* bb, void* y, float rw, int n,
                                       int h, int w, void* stream) {
  return launch_f32_tc<4, kF4TcGroups, kTcWidth, kF4TcTiles, kF4F32Nq, kF4F32Warps>(
      x, ua, ba, ub, bb, y, rw, n, h, w, stream);
}
