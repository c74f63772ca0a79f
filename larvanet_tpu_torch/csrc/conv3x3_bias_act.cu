// Fused SAME 3x3 convolution + bias + activation, NHWC x HWIO, for Hopper.
//
// Replaces the TPU kernel `conv3x3_bias_act_pallas`
// (larvanet_tpu/ops/pallas_conv.py:61-131): the same function, y =
// act(conv3x3_same(x, k) + b) with act in {none, relu, leaky_relu (any
// slope), relu6}, accumulated in f32 and stored in the input dtype (f32 or
// bf16), the activation applied in f32 after the bias. In the
// port it carries every 3x3 conv of the EDSR forward (37 launches per x4
// forward). Three paths, chosen by shape in ops/conv3x3.py `path_for`:
//
// Narrow-output path, `conv3x3_bias_act_{f32,bf16}_narrow`: F <= 8 with C
// a multiple of 16 up to 64, both dtypes (EDSR's 64->3 final_conv, at the
// HR size). Bound on an H100 SXM: at 4 x 768x768 the conv reads 302 MB of
// x and does 8.2 GFLOP in bf16 (0.094 ms at 3.35 TB/s), twice the bytes in
// f32 (0.189 ms): a streaming kernel, bound by its bytes in both dtypes
// once the bf16 products run on the tensor cores (on the CUDA cores their
// FMAs alone would take 0.122 ms). Persistent blocks (8 warps, one an SM)
// walk tiles of 32 output columns; the tile's input halo comes by 16-byte
// cp.async (.cg, zero-filled outside the image) into a ring of two stages,
// the next step's copy in flight while this step's products run, and the
// outputs of each warp row are staged in shared memory and stored by
// neighbouring lanes to neighbouring values. bf16: 16-row tiles with all C
// channels a stage, C padded to 64 with zeros (pixel stride 64 + 8,
// conflict-free for ldmatrix); each warp owns a 16-pixel M tile x 4 rows on
// mma.sync.m16n8k16 with F padded to n = 8, B (the whole 9 x 64 x 8 weight)
// held in registers, and each A operand (ldmatrix.x4) loaded once per halo
// row, kw tap and k-step and used for the up to three output rows it is a
// kh tap of: one kernel for every shape. f32: 32-row tiles in 16-channel
// chunks (pixel stride 20 floats); a thread owns 4 rows of one column and
// F f32 sums per pixel (F padded to 3 or 8: two instances), loads its
// column's 6 halo pixels once per kw tap and 4 channels, and reads each
// weight float4 by a broadcast shared by its 4 pixels. What holds it back
// (~2x its bound, PERF.md): the cp.async copies into shared memory, which
// carry the halo's 1.2x (bf16) / 1.13x (f32) re-reads and run below the
// rate of a plain read of x (chip_smoke.py's `read_ms`); two stages hide
// the products only in part, and a third does not fit beside tiles this
// large.
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
// Tensor-core path in f32, `conv3x3_bias_act_f32_tc`: f32 with C and F
// multiples of 16 (the same 35 convs; the f32 default of serve, validate,
// runtime and get_sr). Bound on an H100 SXM: f32-accurate products on the
// tensor cores run at 495 / 3 = 165 TFLOP/s (below), so a 64->64 trunk conv
// at 4 x 192x192 LR (10.9 GFLOP, 75.5 MB) is bound by its operations, 66 us
// (22.5 us of bytes at 3.35 TB/s). One TF32 product keeps 11 significant
// bits of each operand, ~2^-11 relative: over 576-term sums at EDSR's scale
// it misses by ~4e-3, twenty times the f32 bar of 2e-4. So each operand is
// split into tf32 parts, v = hi + lo with hi = rna(v) and lo = rna(v - hi),
// and a x b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (split TF32,
// "3xTF32"; lo_a lo_b, ~2^-22 of the product, is dropped), small products
// first, all on mma.sync.m16n8k8 tf32 with f32 sums. Every operand is
// rounded with cvt.rna (the activations here, on load) or its bit-exact
// equivalent (the weights, split once per weight by the wrapper,
// ops/conv3x3.py `split_weight`): the tensor core reads a .tf32 operand by
// ignoring its low 13 bits, so an unrounded operand is truncated and lo
// carries the wrong rest. The design is the bf16 path's with mma.sync in
// place of WMMA: persistent blocks of 12 warps keep BN = 64 outputs and
// walk 24 x 16 tiles; the input halo (f32, pixel stride C + 4 floats, an
// odd multiple of 16 bytes, so the 8 rows of an ldmatrix phase fall in
// distinct banks at every tap shift) comes by 16-byte cp.async with
// zero-fill and stays for the 9 taps; A operands are read from it by
// ldmatrix.x4 (8 rows of 4 floats a matrix hand each lane the tf32 fragment
// element, as CUTLASS's SM80 tf32 iterators do) and split once per k-step
// for all of a warp's 8 n8 tiles. Shared memory is what runs out first: the
// halo is 127 KB at C = 64, and the split weight slab of 9 taps x 64 x 64
// would be 295 KB, so the weights stream through a ring of two stages, one
// tap's hi and lo slabs (34 KB) a stage, the next tap's copy in flight
// during this tap's products: 197 KB at C = 64, one block an SM. A resident
// slab of unsplit f32 weights at BN = 32, split on load, was slower at every
// EDSR shape on the card (more ALU a product, the halo copied once per 32
// outputs). What holds it back (the kernel runs at ~3x its bound, ~2.3x
// faster than F.conv2d without TF32, PERF.md): mma.sync runs TF32 at
// about two thirds of the tensor cores' dense rate, which only wgmma
// reaches, and three products an f32 product take the rest of the gap to
// 165 TFLOP/s; beside the products, the halo copy exposed at each tile's
// start, a barrier a tap, the A split and the B loads take a third of the
// time. Its sums round toward zero on the tensor core, so its error (~6e-5
// at the phase-3 scale of chip_smoke.py) is a few times that of the f32
// CUDA-core entry, within the same bar. Next: wgmma (which takes tf32) fed
// by TMA, as for the bf16 path.
//
// CUDA-core path, `conv3x3_bias_act_f32` and `conv3x3_bias_act_bf16`: f32
// and bf16 with C or F not a multiple of 16, outside the narrow path (EDSR's
// 3->64 first_conv; the 64->3 final_conv ran here before the narrow path,
// and the entries still take it; the trunk and upsample convs in f32 ran
// here before the f32 tensor-core path, and the f32 entry still takes
// them). An implicit GEMM on CUDA cores: M = N*H*W
// output pixels, K = 9*C (tap-major, channel-minor: the HWIO kernel reshaped
// to (9C, F)), N_gemm = F. A block owns a BM x BN output tile and walks K in
// BK slices: each slice of the virtual im2col matrix is gathered straight
// from x into shared memory, with the SAME zero padding computed by masks on
// the pixel's (h, w). Each thread keeps a TM x TN f32 accumulator in
// registers and the epilogue adds the bias, applies the activation and masks
// the ragged edges in M and F. Two tile shapes: 128x64 for wide outputs and
// 256x4 for F <= 4 (the final 64->3 conv), so the narrow conv does not pay
// for 60 idle columns. In f32 a trunk conv is bound by operations (0.16 ms
// at 67 TFLOP/s); the final 64->3 conv by its bytes. What it leaves on the
// table: synchronous loads with two barriers per K slice, each input pixel
// fetched 9 times from L2, and in the final conv 64 x 9 gathered values per
// pixel for 3 outputs.

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

enum ActKind { kNone = 0, kRelu = 1, kLeakyRelu = 2, kRelu6 = 3 };

// The epilogue's activation, applied in f32 after the bias: its kind and
// leaky_relu's negative slope (0.1f for the families' leaky_relu; MSRR's
// ablation takes any)
struct Act {
  int kind;
  float slope;
};

__device__ __forceinline__ float activate(float v, Act act) {
  if (act.kind == kRelu) return fmaxf(v, 0.f);
  if (act.kind == kLeakyRelu) return v >= 0.f ? v : act.slope * v;
  if (act.kind == kRelu6) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv3x3_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ bias, T* __restrict__ y,
                            int n, int h_img, int w_img, int c, int f, Act act) {
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
      y[m * f + ff] = from_f32<T>(activate(acc[i][j] + bias[ff], act));
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, const void* bias, void* y, int n, int h, int w_img,
            int c, int f, Act act, cudaStream_t stream) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  const long long m_total = (long long)n * h * w_img;
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((f + BN - 1) / BN));
  conv3x3_bias_act_kernel<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), n, h, w_img, c, f, act);
}

template <typename T>
int conv3x3_bias_act(const void* x, const void* w, const void* bias, void* y, int n, int h,
                     int w_img, int c, int f, Act act, void* stream) {
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

// tile sp of TH x TW output pixels; tiles run along W, then H, then images
template <int TH, int TW>
__device__ __forceinline__ TcTile tile_of(const TcShape& s, long long sp) {
  const long long rest = sp / s.w_tiles;
  return {rest / s.h_tiles, (int)(rest % s.h_tiles) * TH, (int)(sp % s.w_tiles) * TW};
}

// a 16-byte cp.async, or 16 zero bytes if `zero`. kL2Only (the narrow path)
// caches in L2 only (.cg: the halo is read back from shared memory, never
// through L1); the tensor-core path keeps the pipeline primitive's copy.
template <bool kL2Only>
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool zero) {
#ifdef __CUDA_ARCH__
  if (kL2Only) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(zero ? 0 : 16));
    return;
  }
#endif
  __pipeline_memcpy_async(dst, src, 16, zero ? 16 : 0);
}

// the halo of a TH x TW tile, (TH + 2) x (TW + 2) pixels from (h0 - 1, w0 -
// 1), channels c0 .. c0 + kc at a pixel stride of ld values: 16 bytes per
// copy, zeros outside the image; a zero-filled copy reads nothing but still
// names a valid address
template <int TH, int TW, int kThreads, bool kL2Only, typename T>
__device__ __forceinline__ void copy_halo(T* halo, int ld, const T* __restrict__ x,
                                          const TcShape& s, TcTile t, int c0, int kc) {
  constexpr int kPer = 16 / sizeof(T);  // values a copy
  constexpr int kW = TW + 2;
  const T* x_img = x + t.img * s.h_img * s.w_img * s.c;
  const int groups = kc / kPer;
  for (int e = threadIdx.x; e < (TH + 2) * kW * groups; e += kThreads) {
    const int p = e / groups;
    const int g = e - p * groups;
    const int hh = t.h0 - 1 + p / kW;
    const int ww = t.w0 - 1 + p % kW;
    const bool inside = hh >= 0 && hh < s.h_img && ww >= 0 && ww < s.w_img;
    const T* src = inside ? x_img + ((long long)hh * s.w_img + ww) * s.c + c0 + kPer * g : x;
    cp_async16<kL2Only>(halo + p * ld + kPer * g, src, !inside);
  }
}

// as many blocks of `kernel` as the card holds at once
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, long long* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  *blocks = (long long)sms * per_sm;
  return cudaSuccess;
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
                           TcShape s, Act act) {
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

  copy_halo<kTH, kTW, kTcThreads, false>(halo, lda, x, s, tile_of<kTH, kTW>(s, first), 0, kc_max);
  __pipeline_commit();
  copy_slab(slab, ldb, w, s, f0, nj, 0, kc_max);
  for (int i = threadIdx.x; i < 16 * nj; i += kTcThreads) bias_s[i] = bias[f0 + i];

  FragC acc[kRW][kNJ];
  for (long long step = 0; step < steps; ++step) {
    const TcTile t = tile_of<kTH, kTW>(s, first + step / chunks * groups);
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
      copy_halo<kTH, kTW, kTcThreads, false>(halo, lda, x, s,
                                      tile_of<kTH, kTW>(s, first + (step + 1) / chunks * groups),
                                      c1, kc1);
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
              for (int q = 0; q < 2; ++q)
                v[q] = activate(st[p * kStageLd + 8 * half + 2 * i + q] + bias_s[fc + 2 * i + q],
                                act);
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

// one persistent launch of a tensor-core kernel whose shared-memory
// attribute `attr` has been set: as many blocks as fit on the card at once,
// a multiple of the F tiles, at most one a pixel tile per F tile
template <typename T, typename K>
int launch_tc(K kernel, cudaError_t attr, int smem, const TcShape& s, const void* x,
              const void* w, const void* bias, void* y, Act act, void* stream) {
  if (attr != cudaSuccess) return (int)attr;
  long long fit = 0;
  const cudaError_t err = resident_blocks(kernel, kTcThreads, smem, &fit);
  if (err != cudaSuccess) return (int)err;
  const int f_tiles = (s.f + kTcBN - 1) / kTcBN;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  long long groups = fit / f_tiles;
  groups = groups < 1 ? 1 : (groups > n_tiles ? n_tiles : groups);
  kernel<<<(unsigned)(groups * f_tiles), kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), s, act);
  return (int)cudaGetLastError();
}

// each instance sets its largest chunk's shared memory (above 48 KB) once
// per process
template <bool kFull>
int bf16_tc(const void* x, const void* w, const void* bias, void* y, const TcShape& s, Act act,
            void* stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_bf16_tc_kernel<kFull>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, tc_smem_bytes(kKC));
  return launch_tc<__nv_bfloat16>(conv3x3_bf16_tc_kernel<kFull>, attr,
                                  tc_smem_bytes(s.c < kKC ? s.c : kKC), s, x, w, bias, y, act,
                                  stream);
}

// what both tensor-core entries take: C and F multiples of 16, x, w and y
// 16-byte aligned (16-byte copies and stores)
int tc_refusal(const void* x, const void* w, const void* y, int n, int h, int w_img, int c,
               int f) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || f <= 0 || c % 16 || f % 16)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(w) |
       reinterpret_cast<std::uintptr_t>(y)) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

int conv3x3_bias_act_tc(const void* x, const void* w, const void* bias, void* y, int n,
                        int h, int w_img, int c, int f, Act act, void* stream) {
  const int refused = tc_refusal(x, w, y, n, h, w_img, c, f);
  if (refused) return refused;
  const TcShape s{n, h, w_img, c, f, (h + kTH - 1) / kTH, (w_img + kTW - 1) / kTW};
  return f % kTcBN == 0 ? bf16_tc<true>(x, w, bias, y, s, act, stream)
                        : bf16_tc<false>(x, w, bias, y, s, act, stream);
}

// ---- tensor-core path, f32 (C % 16 == 0, F % 16 == 0): split TF32 ----

// mma.sync.m16n8k8 tf32 operands in the PTX ISA's register layouts, g =
// lane / 4, t = lane % 4. A, 16 pixels x 8 inputs: a[0] (pixel g, input t),
// a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4). B, 8 inputs x 8
// outputs: b0 (input t, output g), b1 (t + 4, g). D, 16 pixels x 8
// outputs: d[2e + i] is (pixel g + 8e, output 2t + i).

// the halo's (and a weight slab row's) stride in floats for a chunk of kc
// channels: 16 (kc / 4 + 1) bytes, an odd multiple of 16, so the 8 rows of
// an ldmatrix phase fall in distinct banks at every tap shift
__host__ __device__ constexpr int f32_ld(int kc) { return kc + 4; }

// the halo, two stages of the weight ring (a hi and a lo slab of kTcBN
// output rows each), the bias
__host__ __device__ constexpr int f32_tc_smem_bytes(int kc) {
  return 4 * ((kHaloPix + 2 * 2 * kTcBN) * f32_ld(kc) + kTcBN);
}

// ldmatrix.x4 from shared memory: lane l names row l % 8 of 8x8 b16 matrix
// l / 8 and receives, from each matrix i, its elements (g, 2t) and (g, 2t +
// 1) in r[i]. Read as 8 rows of 4 floats, matrix i hands lane l the float
// (g, t): the tf32 fragments above, as CUTLASS's SM80 tf32 iterators load
// them.
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

// Persistent, as the bf16 kernel: block b keeps the output channels f0 =
// (b % f_tiles) * BN and walks the pixel tiles b / f_tiles, + groups, ...; a
// step is one (tile, chunk of C). The halo (the step's channels, f32) stays
// for the step's 9 taps; the weights stream through a ring of two stages,
// one tap's hi and lo slabs a stage: slab q = 9 step + tap is copied while
// slab q - 1's products run, one barrier a tap. w holds the wrapper's split
// weights, hi then lo, each [9][F][C]. Each warp owns kRW rows of 16 pixels
// x the block's BN outputs (kRW x 8 accumulator tiles in registers); per
// k-step it loads and splits its kRW A operands once and uses each for all
// its n8 tiles, three products an accumulator: lo x hi, hi x lo, then hi x
// hi. The epilogue adds the bias, applies the activation and stores float2
// pairs straight from the accumulators; the next step's halo is copied
// while it runs. kFull: F % BN == 0, no product or load predicated.
template <bool kFull>
__global__ void __launch_bounds__(kTcThreads, 1)
    conv3x3_f32_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ y, TcShape s,
                          Act act) {
  constexpr int kNT = kTcBN / 8;  // n8 tiles of a warp
  extern __shared__ __align__(128) float4 f32_smem[];
  const int kc_max = s.c < kKC ? s.c : kKC;
  const int ld = f32_ld(kc_max);
  const int chunks = (s.c + kKC - 1) / kKC;
  // [kHaloPix][ld] halo, [2 stages][hi, lo][kTcBN][ld] ring, the bias
  float* const halo = reinterpret_cast<float*>(f32_smem);
  float* const ring = halo + kHaloPix * ld;
  float* const bias_s = ring + 2 * 2 * kTcBN * ld;

  const int f_tiles = (s.f + kTcBN - 1) / kTcBN;
  const long long groups = gridDim.x / f_tiles;
  const int f0 = (int)(blockIdx.x % f_tiles) * kTcBN;
  const long long first = blockIdx.x / f_tiles;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  if (first >= n_tiles) return;
  const long long steps = ((n_tiles - 1 - first) / groups + 1) * chunks;
  const int live = kFull ? kTcBN : (s.f - f0 < kTcBN ? s.f - f0 : kTcBN);
  const int nt = live / 8;  // live n8 tiles, even (F % 16 == 0)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int row0 = warp * kRW;
  const int mi = lane / 8;  // the ldmatrix matrix this lane names a row of
  // the lane's ldmatrix row: A, pixel lane % 8 + 8 (mi % 2), inputs 4 (mi /
  // 2)..; B, output lane % 8 + 8 (mi / 2) of an n8 pair, inputs 4 (mi % 2)..
  const int a_lane = (lane % 8 + 8 * (mi % 2)) * ld + 4 * (mi / 2);
  const int b_lane = (lane % 8 + 8 * (mi / 2)) * ld + 4 * (mi % 2);

  // slab q into stage q % 2: taps of the step's chunk, rows f0 .. f0 + live
  const long long slabs = steps * 9;
  const auto copy_slab = [&](long long q) {
    if (q >= slabs) return;
    const int tap = (int)(q % 9);
    const int c0 = (int)(q / 9 % chunks) * kKC;
    const int kc = s.c - c0 < kKC ? s.c - c0 : kKC;
    const int per_row = kc / 4;  // 16-byte copies a row
    float* const dst = ring + (q % 2) * 2 * kTcBN * ld;
    for (int e = threadIdx.x; e < 2 * live * per_row; e += kTcThreads) {
      const int row = e / per_row;  // part * live + output
      const int part = row / live;
      const int n = row - part * live;
      const int gi = e - row * per_row;
      const float* src =
          w + (((long long)part * 9 + tap) * s.f + f0 + n) * s.c + c0 + 4 * gi;
      cp_async16<false>(dst + (part * kTcBN + n) * ld + 4 * gi, src, false);
    }
  };

  copy_halo<kTH, kTW, kTcThreads, false>(halo, ld, x, s, tile_of<kTH, kTW>(s, first), 0, kc_max);
  copy_slab(0);
  __pipeline_commit();
  for (int i = threadIdx.x; i < live; i += kTcThreads) bias_s[i] = bias[f0 + i];

  float acc[kRW][kNT][4];
  for (long long step = 0; step < steps; ++step) {
    const TcTile t = tile_of<kTH, kTW>(s, first + step / chunks * groups);
    const int chunk = (int)(step % chunks);
    const int kc = s.c - chunk * kKC < kKC ? s.c - chunk * kKC : kKC;
    if (chunk == 0) {
#pragma unroll
      for (int r = 0; r < kRW; ++r)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const long long q = step * 9 + tap;
      __pipeline_wait_prior(0);
      // slab q (and at tap 0 the step's halo) landed; every warp is done
      // with stage (q + 1) % 2
      __syncthreads();
      copy_slab(q + 1);
      __pipeline_commit();

      const float* a_p = halo + ((row0 + tap / 3) * kHaloW + tap % 3) * ld + a_lane;
      const float* b_hi = ring + (q % 2) * 2 * kTcBN * ld + b_lane;
      const float* b_lo = b_hi + kTcBN * ld;
      for (int k0 = 0; k0 < kc; k0 += 8) {
        unsigned a_hi[kRW][4], a_lo[kRW][4];
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          unsigned raw[4];
          ldsm_x4(raw, a_p + r * kHaloW * ld + k0);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(a_hi[r][i], a_lo[r][i], raw[i]);
        }
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          if (!kFull && 2 * jp >= nt) continue;
          // r[2h], r[2h + 1]: b0, b1 of n8 tile 2 jp + h
          unsigned bh[4], bl[4];
          ldsm_x4(bh, b_hi + 16 * jp * ld + k0);
          ldsm_x4(bl, b_lo + 16 * jp * ld + k0);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < kRW; ++r) mma_tf32(acc[r][2 * jp + h], a_lo[r], bh[2 * h], bh[2 * h + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < kRW; ++r) mma_tf32(acc[r][2 * jp + h], a_hi[r], bl[2 * h], bl[2 * h + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < kRW; ++r) mma_tf32(acc[r][2 * jp + h], a_hi[r], bh[2 * h], bh[2 * h + 1]);
        }
      }
    }

    __syncthreads();  // every warp is done with the halo
    if (step + 1 < steps) {
      const int c1 = (int)((step + 1) % chunks) * kKC;
      copy_halo<kTH, kTW, kTcThreads, false>(
          halo, ld, x, s, tile_of<kTH, kTW>(s, first + (step + 1) / chunks * groups), c1,
          s.c - c1 < kKC ? s.c - c1 : kKC);
      __pipeline_commit();
    }

    if (chunk == chunks - 1) {
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int oh = t.h0 + row0 + r;
        if (oh >= s.h_img) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ow = t.w0 + g + 8 * e;
          if (ow >= s.w_img) continue;
          float* const out = y + ((t.img * s.h_img + oh) * s.w_img + ow) * s.f + f0 + 2 * tq;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (!kFull && j >= nt) continue;
            const int fc = 8 * j + 2 * tq;
            *reinterpret_cast<float2*>(out + 8 * j) =
                make_float2(activate(acc[r][j][2 * e] + bias_s[fc], act),
                            activate(acc[r][j][2 * e + 1] + bias_s[fc + 1], act));
          }
        }
      }
    }
  }
}

template <bool kFull>
int f32_tc(const void* x, const void* w, const void* bias, void* y, const TcShape& s, Act act,
           void* stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_f32_tc_kernel<kFull>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, f32_tc_smem_bytes(kKC));
  return launch_tc<float>(conv3x3_f32_tc_kernel<kFull>, attr,
                          f32_tc_smem_bytes(s.c < kKC ? s.c : kKC), s, x, w, bias, y, act,
                          stream);
}

int conv3x3_bias_act_tc_f32(const void* x, const void* w, const void* bias, void* y, int n,
                            int h, int w_img, int c, int f, Act act, void* stream) {
  const int refused = tc_refusal(x, w, y, n, h, w_img, c, f);
  if (refused) return refused;
  const TcShape s{n, h, w_img, c, f, (h + kTH - 1) / kTH, (w_img + kTW - 1) / kTW};
  return f % kTcBN == 0 ? f32_tc<true>(x, w, bias, y, s, act, stream)
                        : f32_tc<false>(x, w, bias, y, s, act, stream);
}

// ---- narrow-output path (F <= 8, C % 16 == 0, C <= 64; f32 and bf16) ----

constexpr int kNwMaxF = 8;
constexpr int kNwMaxC = 64;
constexpr int kNwWarps = 8;
constexpr int kNwThreads = 32 * kNwWarps;
constexpr int kNwTW = 32;        // output columns of a tile
constexpr int kNwHW = kNwTW + 2;  // halo columns
// f32: 32 x 32 tiles, channels in chunks of 16 (halo pixel stride 20 floats,
// 80 bytes: a warp's float4 loads of 32 neighbouring pixels are conflict-free)
constexpr int kNfTH = 32;
constexpr int kNfR = kNfTH / kNwWarps;  // output rows of a thread
constexpr int kNfKC = 16;
constexpr int kNfLd = kNfKC + 4;
constexpr int kNfStage = (kNfTH + 2) * kNwHW * kNfLd;  // floats
constexpr int kNfStages = 2;  // halo stages in the ring
// bf16: 16 x 32 tiles, all C channels at once, padded to kNwMaxC (pixel
// stride kNwMaxC + 8: the 8 rows of an ldmatrix phase in distinct banks); a
// warp owns one 16-column M tile x kNbR rows
constexpr int kNbTH = 16;
constexpr int kNbR = kNbTH / (kNwWarps / 2);
constexpr int kNbStages = 2;

// the f32 kernel's shared memory: the halo stages, the weights as float4 of
// 4 input channels [9][C / 4][F], each warp's output row, the bias
__host__ __device__ constexpr int nf_smem_bytes(int c, int f) {
  return 4 * (kNfStages * kNfStage + 9 * c * f + kNwWarps * kNwTW * f + f);
}

// the bf16 kernel's: the halo stages (kNwMaxC channels), each warp's output
// row (16 pixels x up to 8 values), the bias
constexpr int kNbSmemBytes =
    2 * (kNbStages * (kNbTH + 2) * kNwHW * (kNwMaxC + 8) + kNwWarps * 16 * kNwMaxF) +
    4 * kNwMaxF;

// Writes one output row of a warp, staged as `count` values in `st`
// (pixel-major, F values a pixel), to y at element `dst`: neighbouring lanes
// store neighbouring values, so each store instruction fills whole sectors
// whatever the row's alignment.
template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const T* st, int count, int lane) {
  for (int e = lane; e < count; e += 32) dst[e] = st[e];
}

// Persistent: block b walks steps b, b + gridDim.x, ..., a step being one
// (tile, 16-channel chunk). The halos of the next kNfStages - 1 steps are in
// flight (cp.async) in a ring of stages while this step's products run. A
// thread owns kNfR rows of one column of the tile: per 4 channels and kw tap it
// loads the kNfR + 2 halo pixels of its column (float4) once for the three kh
// taps, and takes each weight float4 by a broadcast read, shared by its kNfR
// pixels. F = s.f is padded to FP sums a pixel, the padded outputs' weights
// zero: two instances, FP = 3 (RGB, and grey padded) and FP = 8, cover every
// F and keep the sums in registers.
template <int FP>
__global__ void __launch_bounds__(kNwThreads, 1)
    conv3x3_narrow_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ bias, float* __restrict__ y, TcShape s,
                              Act act) {
  const int F = s.f;
  extern __shared__ __align__(128) float4 nf_smem[];
  // [kNfStages][kNfTH + 2][kNwHW][kNfLd]
  float* const halo = reinterpret_cast<float*>(nf_smem);
  float4* const w_s = reinterpret_cast<float4*>(halo + kNfStages * kNfStage);
  float* const out_s = reinterpret_cast<float*>(w_s + 9 * (s.c / 4) * FP);
  float* const bias_s = out_s + kNwWarps * kNwTW * F;

  const int chunks = s.c / kNfKC;
  const int c4s = s.c / 4;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  const long long first = blockIdx.x;
  if (first >= n_tiles) return;
  const long long steps = ((n_tiles - 1 - first) / gridDim.x + 1) * chunks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kNfR;

  // step j's halo into stage j % kNfStages; one commit group a step, empty
  // past the last step, so that waiting for all but kNfStages - 1 groups
  // always means this step's
  const auto copy_step = [&](long long j) {
    if (j < steps)
      copy_halo<kNfTH, kNwTW, kNwThreads, true>(
          halo + (j % kNfStages) * kNfStage, kNfLd, x, s,
          tile_of<kNfTH, kNwTW>(s, first + j / chunks * gridDim.x), (int)(j % chunks) * kNfKC,
          kNfKC);
    __pipeline_commit();
  };
  for (int j = 0; j < kNfStages - 1; ++j) copy_step(j);
  // w is (9 C, F): component c % 4 of w_s[(tap, c / 4, f)] is w[tap C + c][f],
  // zero for f >= F
  float* const w_f = reinterpret_cast<float*>(w_s);
  for (int e = threadIdx.x; e < 9 * s.c * FP; e += kNwThreads) {
    const int f = e % FP;
    const int k = e / FP;  // tap * C + c
    const int tap = k / s.c;
    const int c = k - tap * s.c;
    w_f[((tap * c4s + c / 4) * FP + f) * 4 + c % 4] = f < F ? w[k * F + f] : 0.f;
  }
  for (int i = threadIdx.x; i < F; i += kNwThreads) bias_s[i] = bias[i];

  float acc[kNfR][FP];
  for (long long step = 0; step < steps; ++step) {
    const TcTile t = tile_of<kNfTH, kNwTW>(s, first + step / chunks * gridDim.x);
    const int chunk = (int)(step % chunks);
    copy_step(step + kNfStages - 1);  // into the stage read by step - 1
    __pipeline_wait_prior(kNfStages - 1);
    __syncthreads();  // this step's halo (and, at first, the weights) landed

    if (chunk == 0) {
#pragma unroll
      for (int r = 0; r < kNfR; ++r)
#pragma unroll
        for (int f = 0; f < FP; ++f) acc[r][f] = 0.f;
    }
    const float* col = halo + (step % kNfStages) * kNfStage + (row0 * kNwHW + lane) * kNfLd;
    const float4* w_chunk = w_s + chunk * (kNfKC / 4) * FP;
#pragma unroll
    for (int q = 0; q < kNfKC / 4; ++q) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float4 xv[kNfR + 2];
#pragma unroll
        for (int j = 0; j < kNfR + 2; ++j)
          xv[j] = *reinterpret_cast<const float4*>(col + (j * kNwHW + dx) * kNfLd + 4 * q);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int f = 0; f < FP; ++f) {
            const float4 wv = w_chunk[((dy * 3 + dx) * c4s + q) * FP + f];
#pragma unroll
            for (int r = 0; r < kNfR; ++r) {
              const float4 v = xv[r + dy];
              acc[r][f] = fmaf(v.x, wv.x, acc[r][f]);
              acc[r][f] = fmaf(v.y, wv.y, acc[r][f]);
              acc[r][f] = fmaf(v.z, wv.z, acc[r][f]);
              acc[r][f] = fmaf(v.w, wv.w, acc[r][f]);
            }
          }
        }
      }
    }

    if (chunk == chunks - 1) {
      // epilogue: each row of the warp through its staging, then stored
      float* const st = out_s + warp * kNwTW * F;
      const int live = s.w_img - t.w0 < kNwTW ? s.w_img - t.w0 : kNwTW;
#pragma unroll
      for (int r = 0; r < kNfR; ++r) {
#pragma unroll
        for (int f = 0; f < FP; ++f)
          if (f < F) st[lane * F + f] = activate(acc[r][f] + bias_s[f], act);
        __syncwarp();
        const int oh = t.h0 + row0 + r;
        if (oh < s.h_img)
          store_row(y + ((t.img * s.h_img + oh) * s.w_img + t.w0) * F, st, live * F, lane);
        __syncwarp();  // the next row overwrites the staging
      }
    }
    __syncthreads();  // this stage may now be overwritten
  }
}

// mma.sync.m16n8k16 operands in the PTX ISA's register layouts, g = lane /
// 4, t = lane % 4. A, 16 pixels x 16 inputs: a[i] holds (pixel g + 8 (i %
// 2), inputs 8 (i / 2) + 2t, + 1). B, 16 inputs x 8 outputs: b[i] holds
// (inputs 8i + 2t, + 1; output g). D, 16 pixels x 8 outputs: d[2e + i] is
// (pixel g + 8e, output 2t + i).
struct NarrowA {
  unsigned r[4];
};

// ldmatrix.x4 of an A operand: 16 pixels from p (stride ld values) x inputs
// 0..15; lane l names row l % 8 of matrix l / 8, which covers pixels 8 (i %
// 2).. and inputs 8 (i / 2)..
__device__ __forceinline__ void load_a16(NarrowA& a, const __nv_bfloat16* p, int ld, int lane) {
  const int i = lane / 8;
  const __nv_bfloat16* row = p + (lane % 8 + 8 * (i % 2)) * ld + 8 * (i / 2);
#ifdef __CUDA_ARCH__
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
               : "r"(addr));
#elif !defined(__CUDACC__)
  emu_ldmatrix_x4(a.r, row);  // the CPU stand-in (ops/emulate.py)
#endif
}

// d += a x b on one m16n8k16 product
__device__ __forceinline__ void mma_n8(float (&d)[4], const NarrowA& a, const unsigned (&b)[2]) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b[0]), "r"(b[1]));
#elif !defined(__CUDACC__)
  emu_mma_m16n8k16(d, a.r, b[0], b[1]);
#endif
}

// Persistent: block b walks tiles b, b + gridDim.x, ...; the halos (all C
// channels) of the next kNbStages - 1 tiles are in flight (cp.async) in a ring
// of stages while this tile's products run. Output channels are padded to n = 8
// (F <= 8 live). Warp w owns M tile w % 2 (16 columns) x kNbR rows from row
// kNbR (w / 2). B, the whole 9 x C x 8 weight, stays in registers (9 KS
// k-steps x 2). Each A operand, loaded once per halo row, kw tap and k-step,
// serves the up to three output rows it is a kh tap of. C = s.c is padded to
// kNwMaxC: the halo's channels past C are zeroed once and their weights are
// zero, so one instance covers every C.
__global__ void __launch_bounds__(kNwThreads, 1)
    conv3x3_narrow_tc_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                             TcShape s, Act act) {
  constexpr int KS = kNwMaxC / 16;  // k-steps a tap
  constexpr int kLd = kNwMaxC + 8;
  constexpr int kStage = (kNbTH + 2) * kNwHW * kLd;  // bf16 values
  const int C = s.c;
  extern __shared__ __align__(128) float4 nb_smem[];
  __nv_bfloat16* const halo = reinterpret_cast<__nv_bfloat16*>(nb_smem);  // [kNbStages][kStage]
  __nv_bfloat16* const out_s = halo + kNbStages * kStage;  // [kNwWarps][16 * kNwMaxF]
  float* const bias_s = reinterpret_cast<float*>(out_s + kNwWarps * 16 * kNwMaxF);

  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  const long long first = blockIdx.x;
  if (first >= n_tiles) return;
  const long long tiles = (n_tiles - 1 - first) / gridDim.x + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int col0 = 16 * (warp % 2);
  const int row0 = kNbR * (warp / 2);

  // tile j's halo into stage j % kNbStages, one commit group a tile (as in
  // the f32 kernel); at C = kNwMaxC the copy's channel count is a constant,
  // and its index math has no division
  const auto copy_tile = [&](long long j) {
    if (j < tiles) {
      __nv_bfloat16* const dst = halo + (j % kNbStages) * kStage;
      const TcTile t = tile_of<kNbTH, kNwTW>(s, first + j * gridDim.x);
      if (C == kNwMaxC)
        copy_halo<kNbTH, kNwTW, kNwThreads, true>(dst, kLd, x, s, t, 0, kNwMaxC);
      else
        copy_halo<kNbTH, kNwTW, kNwThreads, true>(dst, kLd, x, s, t, 0, C);
    }
    __pipeline_commit();
  };
  // the padded channels C .. kNwMaxC of every halo pixel, which no copy writes
  const int pad = (kNwMaxC - C) / 8;  // 16-byte groups a pixel
  for (int e = threadIdx.x; e < kNbStages * (kNbTH + 2) * kNwHW * pad; e += kNwThreads)
    *reinterpret_cast<uint4*>(halo + (e / pad) * kLd + C + 8 * (e % pad)) = uint4{0, 0, 0, 0};
  for (int j = 0; j < kNbStages - 1; ++j) copy_tile(j);
  // w is (9 C, F): b[tap KS + kk][i] = (w[tap C + c][g], w[tap C + c + 1][g])
  // with c = 16 kk + 8 i + 2 tq; zero for the padded outputs g >= F and the
  // padded channels c >= C
  unsigned b[9 * KS][2];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = 16 * kk + 8 * i + 2 * tq;
        unsigned lo = 0, hi = 0;
        if (g < s.f && c < C) {
          lo = __bfloat16_as_ushort(w[(tap * C + c) * s.f + g]);
          hi = __bfloat16_as_ushort(w[(tap * C + c + 1) * s.f + g]);
        }
        b[tap * KS + kk][i] = lo | (hi << 16);
      }
  for (int i = threadIdx.x; i < s.f; i += kNwThreads) bias_s[i] = bias[i];

  for (long long i = 0; i < tiles; ++i) {
    const TcTile t = tile_of<kNbTH, kNwTW>(s, first + i * gridDim.x);
    copy_tile(i + kNbStages - 1);  // into the stage read by tile i - 1
    __pipeline_wait_prior(kNbStages - 1);
    __syncthreads();  // this tile's halo landed

    float acc[kNbR][4];
#pragma unroll
    for (int r = 0; r < kNbR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    const __nv_bfloat16* base = halo + (i % kNbStages) * kStage + (row0 * kNwHW + col0) * kLd;
#pragma unroll
    for (int hr = 0; hr < kNbR + 2; ++hr)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          NarrowA a;
          load_a16(a, base + (hr * kNwHW + dx) * kLd + 16 * kk, kLd, lane);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int r = hr - dy;
            if (r >= 0 && r < kNbR) mma_n8(acc[r], a, b[(dy * 3 + dx) * KS + kk]);
          }
        }

    // epilogue: each row of the warp's M tile through its staging, then stored
    __nv_bfloat16* const st = out_s + warp * 16 * kNwMaxF;
    const int left = s.w_img - t.w0 - col0;
    const int live = left < 16 ? left : 16;
#pragma unroll
    for (int r = 0; r < kNbR; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = 2 * tq + q;
          if (f < s.f)
            st[(g + 8 * e) * s.f + f] =
                __float2bfloat16_rn(activate(acc[r][2 * e + q] + bias_s[f], act));
        }
      __syncwarp();
      const int oh = t.h0 + row0 + r;
      if (oh < s.h_img && live > 0)
        store_row(y + ((t.img * s.h_img + oh) * s.w_img + t.w0 + col0) * s.f, st, live * s.f,
                  lane);
      __syncwarp();  // the next row overwrites the staging
    }
    __syncthreads();  // this stage may now be overwritten
  }
}

// one persistent launch of a narrow kernel whose shared-memory attribute
// `attr` has been set: as many blocks as the card holds at once, at most
// one a tile
template <typename T, typename K>
int launch_narrow(K kernel, cudaError_t attr, int smem, const TcShape& s, const void* x,
                  const void* w, const void* bias, void* y, Act act, void* stream) {
  if (attr != cudaSuccess) return (int)attr;
  long long blocks = 0;
  const cudaError_t err = resident_blocks(kernel, kNwThreads, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  blocks = blocks > n_tiles ? n_tiles : blocks;
  kernel<<<(unsigned)blocks, kNwThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), s, act);
  return (int)cudaGetLastError();
}


// each f32 instance sets its largest shared memory once per process
template <int FP>
int narrow_f32(const void* x, const void* w, const void* bias, void* y, const TcShape& s,
               Act act, void* stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_narrow_f32_kernel<FP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, nf_smem_bytes(kNwMaxC, FP));
  return launch_narrow<float>(conv3x3_narrow_f32_kernel<FP>, attr, nf_smem_bytes(s.c, FP), s, x,
                              w, bias, y, act, stream);
}

// what the narrow entries take: F <= 8, C a multiple of 16 up to 64, x
// 16-byte aligned (its 16-byte halo copies)
int narrow_refusal(const void* x, int n, int h, int w_img, int c, int f) {
  if (n <= 0 || h <= 0 || w_img <= 0 || f < 1 || f > kNwMaxF || c < 16 || c > kNwMaxC ||
      c % 16)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<std::uintptr_t>(x) % 16) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

int conv3x3_narrow_f32(const void* x, const void* w, const void* bias, void* y, int n, int h,
                       int w_img, int c, int f, Act act, void* stream) {
  const int refused = narrow_refusal(x, n, h, w_img, c, f);
  if (refused) return refused;
  const TcShape s{n, h, w_img, c, f, (h + kNfTH - 1) / kNfTH, (w_img + kNwTW - 1) / kNwTW};
  return f <= 3 ? narrow_f32<3>(x, w, bias, y, s, act, stream)
                : narrow_f32<kNwMaxF>(x, w, bias, y, s, act, stream);
}

int conv3x3_narrow_bf16(const void* x, const void* w, const void* bias, void* y, int n, int h,
                        int w_img, int c, int f, Act act, void* stream) {
  const int refused = narrow_refusal(x, n, h, w_img, c, f);
  if (refused) return refused;
  const TcShape s{n, h, w_img, c, f, (h + kNbTH - 1) / kNbTH, (w_img + kNwTW - 1) / kNwTW};
  // its shared memory, set once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_narrow_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNbSmemBytes);
  return launch_narrow<__nv_bfloat16>(conv3x3_narrow_tc_kernel, attr, kNbSmemBytes, s, x, w, bias,
                                      y, act, stream);
}

}  // namespace

// Plain C entry points for ctypes. x: (n, h, w, c) contiguous; w: (9c, f)
// contiguous in the dtype of x; bias: (f,) f32; y: (n, h, w, f); act: 0
// none, 1 relu, 2 leaky_relu at `slope`, 3 relu6 (clip to [0, 6]). The launch
// goes on `stream` and does not synchronise; the return value is
// cudaGetLastError() right after the launch (0 = launched).
extern "C" int conv3x3_bias_act_f32(const void* x, const void* w, const void* bias, void* y,
                                    int n, int h, int w_img, int c, int f, int act,
                                    float slope, void* stream) {
  return conv3x3_bias_act<float>(x, w, bias, y, n, h, w_img, c, f, Act{act, slope}, stream);
}

extern "C" int conv3x3_bias_act_bf16(const void* x, const void* w, const void* bias, void* y,
                                     int n, int h, int w_img, int c, int f, int act,
                                     float slope, void* stream) {
  return conv3x3_bias_act<__nv_bfloat16>(x, w, bias, y, n, h, w_img, c, f, Act{act, slope},
                                         stream);
}

// bf16 on the tensor cores; C and F must be multiples of 16 and x, w, y
// 16-byte aligned (cudaErrorInvalidValue / cudaErrorMisalignedAddress
// otherwise, with nothing launched).
extern "C" int conv3x3_bias_act_bf16_tc(const void* x, const void* w, const void* bias,
                                        void* y, int n, int h, int w_img, int c, int f, int act,
                                        float slope, void* stream) {
  return conv3x3_bias_act_tc(x, w, bias, y, n, h, w_img, c, f, Act{act, slope}, stream);
}

// f32 on the tensor cores in split TF32 (3 products an f32 product); w is
// the wrapper's split weight, hi then lo, each [9][F][C] f32 (ops/conv3x3.py
// `split_weight`). C and F must be multiples of 16 and x, w, y 16-byte
// aligned (cudaErrorInvalidValue / cudaErrorMisalignedAddress otherwise,
// with nothing launched).
extern "C" int conv3x3_bias_act_f32_tc(const void* x, const void* w, const void* bias,
                                       void* y, int n, int h, int w_img, int c, int f, int act,
                                       float slope, void* stream) {
  return conv3x3_bias_act_tc_f32(x, w, bias, y, n, h, w_img, c, f, Act{act, slope}, stream);
}

// The narrow-output path, F <= 8 with C a multiple of 16 up to 64: f32 on
// the CUDA cores, bf16 on the tensor cores. x must be 16-byte aligned; any
// other shape or a misaligned x returns cudaErrorInvalidValue /
// cudaErrorMisalignedAddress with nothing launched.
extern "C" int conv3x3_bias_act_f32_narrow(const void* x, const void* w, const void* bias,
                                           void* y, int n, int h, int w_img, int c, int f,
                                           int act, float slope, void* stream) {
  return conv3x3_narrow_f32(x, w, bias, y, n, h, w_img, c, f, Act{act, slope}, stream);
}

extern "C" int conv3x3_bias_act_bf16_narrow(const void* x, const void* w, const void* bias,
                                            void* y, int n, int h, int w_img, int c, int f,
                                            int act, float slope, void* stream) {
  return conv3x3_narrow_bf16(x, w, bias, y, n, h, w_img, c, f, Act{act, slope}, stream);
}
