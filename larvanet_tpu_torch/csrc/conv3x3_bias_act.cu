// Fused SAME 3x3 convolution + bias + activation, NHWC x HWIO, for Hopper.
//
// Replaces the TPU kernel `conv3x3_bias_act_pallas`
// (larvanet_tpu/ops/pallas_conv.py:61-131): the same function, y =
// act(conv3x3_same(x, k) + b) with act in {none, relu, leaky_relu(0.1)},
// accumulated in f32 and stored in the input dtype (f32 or bf16). In the
// port it carries every 3x3 conv of the EDSR forward (37 launches per x4
// forward). Two paths, chosen by shape in ops/conv3x3.py `path_for`:
//
// Tensor-core path, `conv3x3_bias_act_bf16_tc`: bf16 with C and F
// multiples of 16 (35 of EDSR's 37 convs: 64->64 and 64->256).
// Bound on an H100 SXM (989 TFLOP/s bf16 dense tensor, 3.35 TB/s HBM): at
// 4 x 192x192 LR a 64->64 trunk conv is 10.9 GFLOP, 11.0 us at the tensor
// peak, and 37.8 MB of x, k and y, 11.3 us at the memory rate: it sits on
// the ridge, so the design must neither re-read x from device memory nor
// leave the tensor cores idle. An implicit GEMM on WMMA bf16 fragments
// (16x16x16, f32 accumulators), in persistent blocks, one per SM. A block
// keeps BN = 64 output channels and walks tiles of TH x TW = 24 x 16 output
// pixels of one image; each of its 12 warps computes two 16-pixel rows of
// the tile times BN as eight accumulators. The weight slab (9 taps x C x
// BN, transposed so that B fragments load without a transpose) is copied
// into shared memory once per block. Per tile the block copies the input
// halo ((TH+2) x (TW+2) pixels) with 16-byte cp.async copies, zero-filling
// the pixels outside the image (the SAME padding without a padded copy of
// x), then runs 9 taps x C/16 k-steps with no barrier: an A fragment is
// read straight from the halo at the tap's shift, with ldm = the halo's
// pixel stride, so each input pixel comes from L2 once per tile (1.2x with
// the rim) and not once per tap. The pixel stride is an odd multiple of 16
// bf16 values (80 at C = 64): every tap shift then stays 32-byte aligned,
// as the WMMA load needs, at a 2-way bank conflict, the least that
// alignment allows. The next tile's halo is copied while the warps run the
// epilogue: each stages one accumulator at a time in shared memory, adds
// the bias, applies the activation, rounds once to bf16 and writes 16 bytes
// a lane, masking the ragged edges in H and W. 173 KB of shared memory at
// C = 64 (75 KB halo, 83 KB slab); C > 64 goes in chunks of 64, re-copying
// slab and halo per chunk. What holds it back (the kernel runs at ~5x the
// bound): WMMA issues Hopper's older mma.sync, at a fraction of the rate of
// wgmma; each warp reloads A and B fragments from shared memory for every
// 16 products (6 ldmatrix per 16 HMMA); one block an SM leaves 12 warps to
// hide latency; the halo copy overlaps only the epilogue. Next for this
// path: wgmma on shared-memory descriptors fed by TMA, with warp-specialised
// producer and consumers.
//
// CUDA-core path, `conv3x3_bias_act_f32` and `conv3x3_bias_act_bf16`: f32,
// and bf16 with C or F not a multiple of 16 (EDSR's 3->64 first_conv and
// 64->3 final_conv). An implicit GEMM on CUDA cores: M = N*H*W output
// pixels, K = 9*C (tap-major, channel-minor: the HWIO kernel reshaped to
// (9C, F)), N_gemm = F. A block owns a BM x BN output tile and walks K in
// BK slices: each slice of the virtual im2col matrix is gathered straight
// from x into shared memory, with the SAME zero padding computed by masks
// on the pixel's (h, w). Each thread keeps a TM x TN f32 accumulator in
// registers and the epilogue adds the bias, applies the activation and
// masks the ragged edges in M and F. Two tile shapes: 128x64 for wide
// outputs and 256x4 for F <= 4 (the final 64->3 conv), so the narrow conv
// does not pay for 60 idle columns. In f32 a trunk conv is bound by
// operations (0.16 ms at 67 TFLOP/s); the final 64->3 conv by its bytes.
// What it leaves on the table: synchronous loads with two barriers per K
// slice, each input pixel fetched 9 times from L2, and in the final conv
// 64 x 9 gathered values per pixel for 3 outputs.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// ---- tensor-core path (bf16, C % 16 == 0, F % 16 == 0) ----

namespace wmma = nvcuda::wmma;

constexpr int kTH = 24;            // output rows of a tile
constexpr int kTW = 16;            // output columns of a tile: one WMMA M tile
constexpr int kRW = 2;             // output rows of a warp
constexpr int kTcBN = 64;          // output channels of a block
constexpr int kNJ = kTcBN / 16;    // accumulator fragments of a warp row
constexpr int kKC = 64;            // input channels per shared-memory chunk
constexpr int kTcWarps = kTH / kRW;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPix = (kTH + 2) * kHaloW;
constexpr int kStageLd = 16 + 4;    // a warp's f32 staging of one fragment: 80-byte rows

// the halo's pixel stride in bf16 values for a chunk of kc channels: an odd
// multiple of 16 (32-byte aligned at every tap shift, 2-way bank conflict)
__host__ __device__ constexpr int halo_ld(int kc) {
  return ((kc + 16) / 16) % 2 ? kc + 16 : kc + 32;
}

// the transposed weight slab's row stride (a row: the kc input channels
// of one tap and output channel): an odd multiple of 8 values, so the 8
// rows of an ldmatrix phase fall in distinct banks
__host__ __device__ constexpr int slab_ld(int kc) { return kc + 8; }

// the halo, the weight slab, one staging fragment per warp, the bias
__host__ __device__ constexpr int tc_smem_bytes(int kc) {
  return 2 * (kHaloPix * halo_ld(kc) + 9 * kTcBN * slab_ld(kc)) +
         4 * (kTcWarps * 16 * kStageLd + kTcBN);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct TcShape {
  int n, h_img, w_img, c, f, h_tiles, w_tiles;
};

struct TcTile {
  long long img;
  int h0, w0;
};

__device__ __forceinline__ TcTile tile_of(const TcShape& s, long long sp) {
  const long long rest = sp / s.w_tiles;
  return {rest / s.h_tiles, (int)(rest % s.h_tiles) * kTH, (int)(sp % s.w_tiles) * kTW};
}

// the halo of a tile, channels c0 .. c0 + kc: 16 bytes (8 channels) per
// copy, zeros outside the image; a zero-filled copy reads nothing but still
// names a valid address
__device__ __forceinline__ void copy_halo(__nv_bfloat16* halo, int lda,
                                          const __nv_bfloat16* __restrict__ x,
                                          const TcShape& s, TcTile t, int c0, int kc) {
  const __nv_bfloat16* x_img = x + t.img * s.h_img * s.w_img * s.c;
  const int groups = kc / 8;
  for (int e = threadIdx.x; e < kHaloPix * groups; e += kTcThreads) {
    const int p = e / groups;
    const int g = e - p * groups;
    const int hh = t.h0 - 1 + p / kHaloW;
    const int ww = t.w0 - 1 + p % kHaloW;
    const bool inside = hh >= 0 && hh < s.h_img && ww >= 0 && ww < s.w_img;
    const __nv_bfloat16* src =
        inside ? x_img + ((long long)hh * s.w_img + ww) * s.c + c0 + 8 * g : x;
    __pipeline_memcpy_async(halo + p * lda + 8 * g, src, 16, inside ? 0 : 16);
  }
}

// the weight slab of channels c0 .. c0 + kc, transposed: slab[tap][n][k] =
// w[tap * C + c0 + k][f0 + n] for the block's live output channels n, so
// that a B fragment is col_major and loads without a transpose. Each thread
// reads 8 output channels at once (16 bytes, neighbouring threads on
// neighbouring channels), kBatch reads in flight before their transposed
// stores; a block copies the slab once when C <= kKC.
__device__ __forceinline__ void copy_slab(__nv_bfloat16* slab, int ldb,
                                          const __nv_bfloat16* __restrict__ w,
                                          const TcShape& s, int f0, int nj, int c0, int kc) {
  constexpr int kBatch = 8;
  const int groups = 2 * nj;  // 8-channel groups of a row
  const int total = 9 * kc * groups;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kTcThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kTcThreads;
      if (e < total) {
        const int r = e / groups;
        const int g = e - r * groups;
        const int tap = r / kc;
        v[b] = *reinterpret_cast<const uint4*>(
            w + (long long)(tap * s.c + c0 + r - tap * kc) * s.f + f0 + 8 * g);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kTcThreads;
      if (e < total) {
        const int r = e / groups;
        const int g = e - r * groups;
        const int tap = r / kc;
        __nv_bfloat16* dst = slab + (tap * kTcBN + 8 * g) * ldb + r - tap * kc;
        const unsigned word[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i * ldb] = __ushort_as_bfloat16((unsigned short)(word[i / 2] >> (16 * (i % 2))));
      }
    }
  }
}

// load_matrix_sync from shared memory. The C++ API takes a generic pointer,
// and nvcc then issues generic 32-bit loads with 64-bit address arithmetic
// (LD.E in the SASS) instead of ldmatrix; on the card the same WMMA load is
// issued with the .shared state space (LDSM), filling the same fragment
// that wmma::mma_sync consumes.
template <typename Frag>
__device__ __forceinline__ void load_shared(Frag& frag, const __nv_bfloat16* p, int ldm) {
#ifdef __CUDA_ARCH__
  static_assert(sizeof(frag.x) == 16, "a bf16 16x16x16 A or B fragment is 4 registers");
  unsigned* r = reinterpret_cast<unsigned*>(frag.x);
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (std::is_same<Frag, FragA>::value) {
    asm volatile("wmma.load.a.sync.aligned.row.m16n16k16.shared.bf16 {%0, %1, %2, %3}, [%4], %5;"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr), "r"(ldm));
  } else {
    asm volatile("wmma.load.b.sync.aligned.col.m16n16k16.shared.bf16 {%0, %1, %2, %3}, [%4], %5;"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr), "r"(ldm));
  }
#else
  wmma::load_matrix_sync(frag, p, ldm);
#endif
}

// the fragments of k-step ks = tap * (kc / 16) + k / 16: the warp's kRW
// A tiles, read from the halo at the tap's shift, and the block's live B
// tiles from the slab
__device__ __forceinline__ void load_step(FragA (&a)[kRW], FragB (&b)[kNJ],
                                          const __nv_bfloat16* halo, int lda,
                                          const __nv_bfloat16* slab, int ldb, int kc, int ks,
                                          int row0, int nj) {
  const int per_tap = kc / 16;
  const int tap = ks / per_tap;
  const int k0 = (ks - tap * per_tap) * 16;
  const __nv_bfloat16* a_p = halo + ((row0 + tap / 3) * kHaloW + tap % 3) * lda + k0;
#pragma unroll
  for (int r = 0; r < kRW; ++r) load_shared(a[r], a_p + r * kHaloW * lda, lda);
  const __nv_bfloat16* b_p = slab + tap * kTcBN * ldb + k0;
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
    if (j < nj) load_shared(b[j], b_p + 16 * j * ldb, ldb);
}

__device__ __forceinline__ void mma_step(FragC (&acc)[kRW][kNJ], const FragA (&a)[kRW],
                                         const FragB (&b)[kNJ], int nj) {
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
    if (j < nj)
#pragma unroll
      for (int r = 0; r < kRW; ++r) wmma::mma_sync(acc[r][j], a[r], b[j], acc[r][j]);
}

// Persistent: block b keeps the output channels f0 = (b % f_tiles) * BN and
// walks the pixel tiles b / f_tiles, + groups, + 2 groups, ...; a step is
// one (tile, chunk of C). With C <= kKC (one chunk) the slab is copied once
// and stays. The next step's halo (and, with more chunks, its slab) is
// copied as soon as this step's products are done, while the warps run
// their epilogues. kFull: F % BN == 0, so every block's BN channels are
// live and no product or load is predicated (a predicated HMMA issues
// more slowly).
template <bool kFull>
__global__ void __launch_bounds__(kTcThreads, 1)
    conv3x3_bf16_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                           TcShape s, int act) {
  extern __shared__ __align__(128) float4 tc_smem[];
  const int kc_max = s.c < kKC ? s.c : kKC;
  const int lda = halo_ld(kc_max);
  const int ldb = slab_ld(kc_max);
  const int chunks = (s.c + kKC - 1) / kKC;
  const bool resident = chunks == 1;
  // [kHaloPix][lda] halo, [9][kTcBN][ldb] slab, the warps' staging, the
  // block's bias
  __nv_bfloat16* const halo = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* const slab = halo + kHaloPix * lda;
  float* const stage = reinterpret_cast<float*>(slab + 9 * kTcBN * ldb);
  float* const bias_s = stage + kTcWarps * 16 * kStageLd;

  const int f_tiles = (s.f + kTcBN - 1) / kTcBN;
  const long long groups = gridDim.x / f_tiles;
  const int f0 = (int)(blockIdx.x % f_tiles) * kTcBN;
  const long long first = blockIdx.x / f_tiles;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  if (first >= n_tiles) return;
  const long long steps = ((n_tiles - 1 - first) / groups + 1) * chunks;
  // live 16-channel fragments
  const int nj = kFull ? kNJ : (s.f - f0 < kTcBN ? s.f - f0 : kTcBN) / 16;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRW;  // the warp's first row in the tile
  float* const st = stage + warp * 16 * kStageLd;

  copy_halo(halo, lda, x, s, tile_of(s, first), 0, kc_max);
  __pipeline_commit();
  copy_slab(slab, ldb, w, s, f0, nj, 0, kc_max);
  for (int i = threadIdx.x; i < 16 * nj; i += kTcThreads) bias_s[i] = bias[f0 + i];

  FragC acc[kRW][kNJ];
  for (long long step = 0; step < steps; ++step) {
    const TcTile t = tile_of(s, first + step / chunks * groups);
    const int chunk = (int)(step % chunks);
    const int c0 = chunk * kKC;
    const int kc = s.c - c0 < kKC ? s.c - c0 : kKC;
    __pipeline_wait_prior(0);
    __syncthreads();

    if (chunk == 0) {
#pragma unroll
      for (int r = 0; r < kRW; ++r)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) wmma::fill_fragment(acc[r][j], 0.f);
    }
    // 9 taps x kc / 16 k-steps, no barrier. One set of fragments: the 12
    // warps of the SM hide each other's load latency, and a second set
    // (loading step ks + 1 during step ks) costs registers.
    const int k_steps = 9 * (kc / 16);
    for (int ks = 0; ks < k_steps; ++ks) {
      FragA a[kRW];
      FragB b[kNJ];
      load_step(a, b, halo, lda, slab, ldb, kc, ks, row0, nj);
      mma_step(acc, a, b, nj);
    }

    __syncthreads();  // the halo (and slab) may be overwritten
    if (step + 1 < steps) {
      const int next = (int)((step + 1) % chunks);
      const int c1 = next * kKC;
      const int kc1 = s.c - c1 < kKC ? s.c - c1 : kKC;
      copy_halo(halo, lda, x, s, tile_of(s, first + (step + 1) / chunks * groups), c1, kc1);
      __pipeline_commit();
      if (!resident) copy_slab(slab, ldb, w, s, f0, nj, c1, kc1);
    }

    if (chunk == chunks - 1) {
      // epilogue, per warp: one fragment at a time through the warp's
      // staging; lane = (pixel, half of the 16 channels), one 16-byte store
      const int p = lane / 2;
      const int half = lane % 2;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int oh = t.h0 + row0 + r;
        const bool live = oh < s.h_img && t.w0 + p < s.w_img;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          if (j >= nj) continue;
          wmma::store_matrix_sync(st, acc[r][j], kStageLd, wmma::mem_row_major);
          __syncwarp();
          if (live) {
            const int fc = 16 * j + 8 * half;
            unsigned word[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float v[2];
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                float u = st[p * kStageLd + 8 * half + 2 * i + q] + bias_s[fc + 2 * i + q];
                if (act == kRelu) {
                  u = fmaxf(u, 0.f);
                } else if (act == kLeakyRelu) {
                  u = u >= 0.f ? u : 0.1f * u;
                }
                v[q] = u;
              }
              word[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
                        ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
            }
            const long long pix = (t.img * s.h_img + oh) * s.w_img + t.w0 + p;
            *reinterpret_cast<uint4*>(y + pix * s.f + f0 + fc) =
                make_uint4(word[0], word[1], word[2], word[3]);
          }
          __syncwarp();  // the next fragment overwrites the staging
        }
      }
    }
  }
}

template <bool kFull>
int launch_tc(const void* x, const void* w, const void* bias, void* y, const TcShape& s,
              int act, void* stream) {
  // once per process and instance: the largest chunk's shared memory
  // exceeds 48 KB
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_bf16_tc_kernel<kFull>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, tc_smem_bytes(kKC));
  if (attr != cudaSuccess) return (int)attr;
  const int smem = tc_smem_bytes(s.c < kKC ? s.c : kKC);
  // as many blocks as fit on the card at once, a multiple of the F tiles
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3x3_bf16_tc_kernel<kFull>, kTcThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int f_tiles = (s.f + kTcBN - 1) / kTcBN;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  long long groups = (long long)sms * per_sm / f_tiles;
  groups = groups < 1 ? 1 : (groups > n_tiles ? n_tiles : groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv3x3_bf16_tc_kernel<kFull><<<(unsigned)(groups * f_tiles), kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), s, act);
  return (int)cudaGetLastError();
}

int conv3x3_bias_act_tc(const void* x, const void* w, const void* bias, void* y, int n,
                        int h, int w_img, int c, int f, int act, void* stream) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || f <= 0 || c % 16 || f % 16)
    return cudaErrorInvalidValue;
  // 16-byte copies and stores of x, w and y
  if ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(w) |
       reinterpret_cast<std::uintptr_t>(y)) % 16)
    return cudaErrorMisalignedAddress;
  const TcShape s{n, h, w_img, c, f, (h + kTH - 1) / kTH, (w_img + kTW - 1) / kTW};
  return f % kTcBN == 0 ? launch_tc<true>(x, w, bias, y, s, act, stream)
                        : launch_tc<false>(x, w, bias, y, s, act, stream);
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

// bf16 on the tensor cores; C and F must be multiples of 16 and x, w, y
// 16-byte aligned (cudaErrorInvalidValue / cudaErrorMisalignedAddress
// otherwise, with nothing launched).
extern "C" int conv3x3_bias_act_bf16_tc(const void* x, const void* w, const void* bias,
                                        void* y, int n, int h, int w_img, int c, int f, int act,
                                        void* stream) {
  return conv3x3_bias_act_tc(x, w, bias, y, n, h, w_img, c, f, act, stream);
}
