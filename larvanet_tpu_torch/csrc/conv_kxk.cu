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
// 24, 54 or 96, on 4-pixel strips; the corners as 4x4 convs of a 4x4 patch,
// 64 -> 192), the input gradient of the live training tail (the same conv on
// the kernel rotated by 180 degrees, 48 -> 64) and the collapsed
// interpolated base (3 -> 3 s^2). conv3x3_bias_act.cu takes 3x3 only.
//
//   y[n, i, j, f] = bias[f] + sum over ky, kx, c of
//                   x[n, i + ky - pt, j + kx - pl, c] * w[ky, kx, c, f]
//
// with x zero outside the image; the output is (H + pt + pb - kh + 1) x
// (W + pl + pr - kw + 1). Sums in f32, the result stored in x's dtype. A
// grouped entry runs G problems of one shape in one launch (x, weights,
// biases and outputs stacked along a leading axis): the border operators
// of the collapsed tail, top + bottom, left + right and the four corners.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense tensor, f32-accurate
// products at 495 / 3 = 165 TFLOP/s in split TF32, 3.35 TB/s): the main
// conv of EDSR-baseline x4 at 4 x 192x192 LR is 22.6 GFLOP against 18.9 MB
// of x and 14.2 MB of y in bf16: 22.9 us of products, 9.9 us of bytes; f32
// 137 us of products. The border operators are a few MFLOP on a few hundred
// KB: their bound is ~1 us, and what they cost is a launch and its latency.
// The weight gradient of the live tail's 5x5 64 -> 48 conv at batch 16 x
// 48x48 is 5.7 GFLOP (f32: 34 us; bf16: 6 us) against 16.5 MB (f32) of x
// and g. Every entry is bound by its operations.
//
// Tensor-core forward, `conv_kxk_{f32,bf16}_tc` and the grouped
// `conv_kxk_group_{f32,bf16}_tc` (C a multiple of 16): an implicit GEMM on
// mma.sync, M = output pixels, N = outputs, K = taps x C. The design:
//
// 1. Output-shaped tiles, chosen by the host from the output: 8 x 16
//    pixels (bf16) or 16 x 16 (f32) in the interior, 1 x 64 for an output
//    one row tall (the top and bottom operators), 64 x 1 for one column
//    wide (left and right), and 16 images of one pixel for a 1 x 1 output
//    (the corners). A warp owns MW m16 tiles (2 in the interior, 1 in the
//    other tiles) x NW n8 tiles (1, 2, 3, 4 or 6), template parameters, so
//    no tensor-core instruction sits under a per-lane predicate (under one,
//    nvcc put a WARPSYNC before each and the kernel ran 2.5x slower).
// 2. Persistent blocks. A block owns a slice (problem, BN outputs) and
//    walks that slice's tiles with a stride; BN is the most outputs whose
//    n8 tiles split evenly over the warps that still gives every SM a
//    block, so the border operators' few tiles spread over the card.
// 3. Weights as chunks: a chunk is one tap's BN rows of 128 bytes of
//    channels (64 bf16 or 32 f32; f32 as hi and lo rows, split once by the
//    wrapper), laid out [problem][channel chunk][tap][hi/lo][F][128 bytes]
//    with each row's 16-byte granules swizzled by the row (granule q at q ^
//    (row & 7)), so the 8 rows of an ldmatrix fall in 8 distinct bank
//    groups. Where every chunk of the slice fits beside the halo ring
//    (bf16 5x5 64 -> 48: 153.6 KB) they are resident: one TMA box (the
//    chunk index its outer dimension) loads them once per block. Else (f32)
//    they stream through a ring of slots, a chunk a box.
// 4. An asynchronous ring. One producer thread issues by TMA each tile's
//    halo ((TH + kh - 1) x (TW + kw - 1) pixels of one channel chunk,
//    from a 4-D tensor map over x whose out-of-bounds zeros are the pads
//    and the ragged edge; the box is 16 bytes wider than the chunk, so the
//    pixels sit 144 bytes apart and an ldmatrix of 8 pixels is conflict
//    free) into 2 slots, and the streamed weight chunks, each slot with a
//    `full` and an `empty` mbarrier; up to 8 consumer warps compute.
// 5. Fragments by ldmatrix.x4 (non-transposed: the halo is [pixel][channel]
//    and the weights [output][channel], both k-contiguous; f32 takes the
//    b16 form on tf32 pairs). f32 runs in split TF32: v = hi + lo, a x b =
//    lo_a hi_b + hi_a lo_b + hi_a hi_b (conv3x3_bias_act.cu's scheme), the
//    activations split as they are loaded.
//
// A pixel's sum runs over channel chunks, then taps, then the chunk's
// 32-byte k-steps, in that order whatever the tile shape, the pixel's place
// in it, the batch or the group: two calls give a pixel the same bits (the
// collapsed tail's probes subtract responses and need exact cancellation;
// the tilings of a frame equal its direct forward).
//
// CUDA-core forward, `conv_kxk_f32` / `conv_kxk_bf16` and the grouped
// `conv_kxk_group_f32` / `conv_kxk_group_bf16` (any C: the 3-channel base,
// the tests' narrow widths): one thread an output value, taps then
// channels in order, f32 FMAs, the weight as [kh kw][F][C].
//
// Weight gradient (x and g in one dtype, f32 sums): for the gradient g of
// the conv's output before its bias,
//
//   dW[ky, kx, c, f] = sum over n, i, j of x[n, i + ky - pt, j + kx - pl, c] * g[n, i, j, f]
//   db[f]            = sum over n, i, j of g[n, i, j, f]
//
// as out = A^T g with the virtual im2col rows of x (kh kw C rows, tap-major,
// then the ones of db) and K = the output pixels, cut into `splits` runs
// whose partial sums a second kernel adds in order: no float atomics, the
// same bits on every run (a resumed training run repeats an uninterrupted
// one).
//
// Tensor-core weight gradient, `conv_kxk_wgrad_{f32,bf16}_tc` (C % 16 == 0,
// kh kw <= 25; conv3x3_wgrad.cu's tensor-core design with kh x kw taps and
// explicit pads): a block owns every tap x 16 channels x up to 48 outputs
// (F = 48 is 6 n8 tiles, not padded to 64; a template parameter) and walks
// its run of 8 x 16 pixel tiles. Per tile it stages, by 16-byte cp.async
// with zero fill outside the image, x's (8 + kh - 1) x (16 + kw - 1) halo
// and the tile's g once for all taps, two stages in flight. 5 warps, each up
// to 5 taps (5 m16 tiles, their halo offsets computed once) x every n8
// tile. bf16: m16n8k16 with f32 sums, both fragments by ldmatrix.x4.trans
// from the [pixel][channel] halo and the [pixel][output] g tile (pixel
// strides an odd multiple of 16 bytes); f32: split TF32 on m16n8k8 with
// both operands split as loaded, plain 32-bit shared loads at pixel strides
// == 8 (mod 16) words, conflict free. db is the staged g tile's column sums
// on the CUDA cores, runs of pixels added in order. The tensor core's f32
// sums round toward zero, so the wrapper caps an f32 run's length
// (ops/conv_kxk.py MAX_TC_PIXELS).
//
// CUDA-core weight gradient, `conv_kxk_wgrad_f32` / `conv_kxk_wgrad_bf16`
// (any shape; chosen for C % 16 != 0 or more than 25 taps): a block sums a
// run of pixels for a tile of 64 rows x 64 outputs, 16 pixels a step, 4 x 4
// sums a thread, gathering x per tap from global memory.
//
// What holds them back (an H100 SXM at 700 W, CUDA graph replays; the
// numbers are PERF.md section 6, row 6; chip_kxk_variants.py measures the
// variants and the clock64 spans). The bf16 5x5 64 -> 48 conv runs at ~4x
// its bound, below F.conv2d: with no products at all it keeps ~85% of its
// time, so its ldmatrix traffic (2 A and 2 B loads for 6 products a warp
// and k-step) binds it, not the halo ring (its blocks wait ~5% of their
// cycles); f32 at ~2.8x, bound by mma.sync's split-TF32 rate (~2.3x its
// time without products). The border groups are latency-bound: a block has
// one or two tiles, its first halo lands ~6k cycles after its start, and
// in f32 each warp carries one accumulator, whose three dependent products
// a k-step form one chain (two blocks an SM, where a streamed ring leaves
// room, took the f32 strips from ~0.048 to ~0.037-0.044 ms). The weight
// gradient's blocks spend ~55% of their cycles on products, at ~12 cycles
// a product a sub-partition, ~30% waiting for their first tile and for
// stages, and land 1 or 2 to an SM (288 tiles of 8 x 16 cut into runs of
// 5); its partial sums are ~13% of it. wgmma, which would lift mma.sync's
// rate, takes tf32 only from K-major shared-memory tiles and was no faster
// in conv3x3_s8.cu.

#include <cuda.h>  // the tensor map's types; the driver call comes through the runtime
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

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

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }

struct Shape {
  int n, h, w, c;  // the input (of one problem)
  int kh, kw, f;   // the kernel
  int pt, pl;      // the top and left pads
  int ho, wo;      // the output
};

// ---- CUDA-core forward (any C) ----

constexpr int kCcThreads = 256;

// Problem blockIdx.y of a group: x, w, bias and y of each problem follow
// the previous one's.
template <typename T>
__global__ void __launch_bounds__(kCcThreads)
    conv_kxk_cc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y, Shape s) {
  const long long total = (long long)s.n * s.ho * s.wo * s.f;
  const long long i = (long long)blockIdx.x * kCcThreads + threadIdx.x;
  if (i >= total) return;
  const long long grp = blockIdx.y;
  x += grp * s.n * s.h * s.w * s.c;
  w += grp * s.kh * s.kw * s.f * s.c;
  bias += grp * s.f;
  y += grp * total;
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

// ---- shared memory, barriers, copies and products ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
#elif !defined(__CUDACC__)
  emu_mbar_init(bar, count);
#endif
}

__device__ __forceinline__ void mbar_init_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}

// one arrival (release: this thread's earlier accesses happen before)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
#elif !defined(__CUDACC__)
  emu_mbar_arrive(bar);
#endif
}

// one arrival that also announces `bytes` a bulk copy will land
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
#elif !defined(__CUDACC__)
  emu_mbar_arrive_expect_tx(bar, bytes);
#endif
}

// the TMA's box of `map` at (c0, c1, c2, c3), innermost first, into dst
// (128-byte aligned); zeros outside the tensor; its bytes complete `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
#elif !defined(__CUDACC__)
  emu_tma_load_4d(dst, map, c0, c1, c2, c3, bar);
#endif
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
#ifdef __CUDA_ARCH__
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
#elif !defined(__CUDACC__)
  emu_mbar_wait(bar, parity);
#endif
}

// ldmatrix.x4 (b16): lane l names row l % 8 of 8 x 8 matrix l / 8 (16
// bytes); lane (g, t) = (l / 4, l % 4) receives in r[i] the 32 bits at bytes
// 4t .. 4t + 3 of matrix i's row g
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* row) {
#ifdef __CUDA_ARCH__
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
#elif !defined(__CUDACC__)
  emu_ldmatrix_x4(r, row);
#endif
}

// ldmatrix.x4.trans (b16): the same rows, each matrix transposed: lane (g,
// t) receives in r[i] the 16-bit elements g of matrix i's rows 2t (low
// half) and 2t + 1
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* row) {
#ifdef __CUDA_ARCH__
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
#elif !defined(__CUDACC__)
  emu_ldmatrix_x4_trans(r, row);
#endif
}

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

// d += a x b on one m16n8k16 bf16 product, f32 sums: a[i] A(g + 8 (i % 2),
// 8 (i / 2) + 2t, + 1); b_i B(8i + 2t, + 1; g); d as mma_tf32's
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

// a 16-byte cp.async, or 16 zero bytes if `zero` (which read nothing but
// still name a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool zero) {
  __pipeline_memcpy_async(dst, src, 16, zero ? 16 : 0);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 4-D tiled tensor map (dims and box innermost first, strides of dims 1-3
// in bytes), zeros outside. cuTensorMapEncodeTiled is reached through the
// runtime, so the library links without -lcuda.
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
               const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
               const cuuint32_t (&box)[4]) {
  static EncodeTiled encode = nullptr;
  static std::mutex mu;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (encode == nullptr) {
      void* fn = nullptr;
      cudaDriverEntryPointQueryResult found;
      const cudaError_t err =
          cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
      if (err != cudaSuccess) return err;
      if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorInvalidValue;
      encode = reinterpret_cast<EncodeTiled>(fn);
    }
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
constexpr CUtensorMapDataType kMapType =
    sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// the card's SM count, asked once
int sm_count(int* sms) {
  static int asked = 0;
  if (asked == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&asked, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = asked;
  return cudaSuccess;
}

// the blocks of `kernel` the card holds at once with `threads` threads and
// `smem` bytes of dynamic shared memory, asked once per (kernel, threads, smem)
template <typename K>
int resident_blocks(K kernel, int threads, int smem, long long* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, long long> asked;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), threads, smem);
  const auto it = asked.find(key);
  if (it != asked.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = (cudaError_t)sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  *blocks = asked[key] = (long long)sms * per_sm;
  return cudaSuccess;
}

// ---- tensor-core forward (C % 16 == 0) ----

constexpr int kChunkBytes = 128;                   // channel bytes of a chunk: a weight row
constexpr int kPixBytes = kChunkBytes + 16;        // a halo pixel: 9 x 16 bytes, conflict free
constexpr int kStepBytes = 32;                     // channel bytes of a k-step
constexpr int kWarps = 8;                          // consumer warps at most
constexpr int kFwdThreads = 32 * (kWarps + 1);     // and the producer warp
constexpr int kMW = 2;                             // m16 tiles of a warp
constexpr int kNW = 6;                             // n8 tiles of a warp at most
constexpr int kSmemLimit = 232448;                 // dynamic shared memory a block may ask for
constexpr int kMaxSlots = 64;                      // streamed weight slots at most
constexpr int kPairSmem = 113 * 1024;              // a block's shared memory, two an SM
constexpr int kPairSlots = 4;                      // streamed slots worth two blocks an SM
constexpr int kStripPx = 64;                       // pixels of a tile one row or column wide
constexpr int kStripMW = 1;                        // m16 tiles of a warp in such tiles

// A launch's plan, made on the host: the problem, the tile, the warps'
// work, the slices, the rings and the shared-memory layout (byte offsets
// from the 128-byte aligned base).
struct FwdPlan {
  int groups, n, h, w, c, kh, kw, f, pt, pl, ho, wo;
  int th, tw, tn, hh, hw;         // the output tile (rows, columns, images) and its halo
  int tiles_w, tiles_h, tiles;    // tiles of one problem
  int mpairs, mw, nw, warps;      // warp u: m16 tiles (u % mpairs) mw + .., n8 tiles (u / mpairs) nw + ..
  int bn, ntb, nblocks, bps;      // outputs of a slice, its n8 tiles, slices a problem, blocks a slice
  int chunks, taps, wchunks;      // channel chunks, taps, weight chunks of a slice
  int resident, hs, ws;           // weights loaded once; halo and weight slots
  int halo_tx, halo_bytes, w_bytes;
  int off_bias, off_w, off_halo, smem_bytes;
};

struct TileAt {
  int img, h0, w0;
};

__device__ __forceinline__ TileAt tile_at(const FwdPlan& p, int tile) {
  return TileAt{tile / (p.tiles_w * p.tiles_h) * p.tn, tile / p.tiles_w % p.tiles_h * p.th,
                tile % p.tiles_w * p.tw};
}

// Block b: slice b / bps (problem, outputs f0 .. f0 + bn), tiles b % bps, +
// bps, ... Warps 0 .. warps - 1 consume, each MW m16 tiles x NW n8 tiles of
// a tile; warp `warps` produces (its lane 0: the TMA of the weight chunks,
// once if resident, and of each tile's halo chunks). Slot i % slots of a
// ring holds the block's i-th use of it. The warp index comes through a
// shuffle, so the compiler knows it, and all that derives from it, to be
// the same across the warp: no tensor-core instruction sits under a
// per-lane predicate.
template <typename T, int MW, int NW>
__global__ void __launch_bounds__(kFwdThreads, 1)
    conv_kxk_tc_kernel(const float* __restrict__ bias, T* __restrict__ y, const FwdPlan p,
                       const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kChunkCh = kChunkBytes / (int)sizeof(T);
  extern __shared__ __align__(128) uint8_t kxk_smem[];
  uint64_t* const halo_full = reinterpret_cast<uint64_t*>(kxk_smem);
  uint64_t* const halo_empty = halo_full + p.hs;
  uint64_t* const w_full = halo_empty + p.hs;
  uint64_t* const w_empty = w_full + p.ws;
  float* const bias_s = reinterpret_cast<float*>(kxk_smem + p.off_bias);
  uint8_t* const wsm = kxk_smem + p.off_w;
  uint8_t* const halo = kxk_smem + p.off_halo;

  const int slice = blockIdx.x / p.bps;
  const int sub = blockIdx.x % p.bps;
  const int grp = slice / p.nblocks;
  const int f0 = slice % p.nblocks * p.bn;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.hs; ++i) {
      mbar_init(halo_full + i, 1);
      mbar_init(halo_empty + i, p.warps);
    }
    for (int i = 0; i < p.ws; ++i) {
      mbar_init(w_full + i, 1);
      mbar_init(w_empty + i, p.warps);
    }
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < p.bn; i += 32 * (p.warps + 1))
    bias_s[i] = f0 + i < p.f ? bias[(long long)grp * p.f + f0 + i] : 0.f;
  __syncthreads();

  if (warp == p.warps) {
    // the producer. Its other lanes leave: a lane that only waited could
    // fall two phases behind a barrier and read the wrong parity
    if (lane != 0) return;
    if (p.resident) {
      // every chunk of the slice in one box: [chunk][hi, lo][bn rows][128 bytes]
      mbar_arrive_expect_tx(w_full, p.wchunks * p.w_bytes);
      tma_load_4d(wsm, &w_map, 0, f0, 0, grp * p.wchunks, w_full);
    }
    // ring slots and the parity of their next use
    int hslot = 0, hround = 0, wslot = 0, wround = 0;
    for (int tile = sub; tile < p.tiles; tile += p.bps) {
      const TileAt t = tile_at(p, tile);
      for (int cc = 0; cc < p.chunks; ++cc) {
        if (hround > 0) mbar_wait(halo_empty + hslot, (unsigned)((hround - 1) & 1));
        mbar_arrive_expect_tx(halo_full + hslot, p.halo_tx);
        tma_load_4d(halo + (long long)hslot * p.halo_bytes, &x_map, cc * kChunkCh, t.w0 - p.pl,
                    t.h0 - p.pt, grp * p.n + t.img, halo_full + hslot);
        if (++hslot == p.hs) hslot = 0, ++hround;
        if (p.resident) continue;
        for (int tap = 0; tap < p.taps; ++tap) {
          if (wround > 0) mbar_wait(w_empty + wslot, (unsigned)((wround - 1) & 1));
          mbar_arrive_expect_tx(w_full + wslot, p.w_bytes);
          tma_load_4d(wsm + (long long)wslot * p.w_bytes, &w_map, 0, f0, 0,
                      (grp * p.chunks + cc) * p.taps + tap, w_full + wslot);
          if (++wslot == p.ws) wslot = 0, ++wround;
        }
      }
    }
    return;
  }

  // the consumers. Warp `warp`: m16 tiles mp MW .. + MW, n8 tiles j0 .. j0 + NW
  const int mp = warp % p.mpairs;
  const int j0 = warp / p.mpairs * NW;
  const int tile_px = p.th * p.tw;
  // the lane's A row: pixel lane % 16 of each m16 tile, 16-byte half lane / 16
  int a_off[MW];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int m = (mp * MW + i) * 16 + lane % 16;
    const int tn = m / tile_px, py = m / p.tw % p.th, px = m % p.tw;
    a_off[i] = ((tn * p.hh + py) * p.hw + px) * kPixBytes + 16 * (lane / 16);
  }
  // the lane's B rows: output row lane % 8 of n8 tile j0 + 2q + lane / 16 (a
  // pair's missing half reads a real row), 16-byte half (lane / 8) % 2 of
  // the k-step, the granule swizzled by the row
  int b_row[(NW + 1) / 2];
#pragma unroll
  for (int q = 0; q < (NW + 1) / 2; ++q) {
    const int jj = j0 + 2 * q + lane / 16;
    b_row[q] = (8 * (jj < p.ntb ? jj : p.ntb - 1) + lane % 8) * kChunkBytes;
  }
  const int b_half = lane / 8 % 2;
  const int b_swz = lane % 8;
  const int gq = lane / 4, tq = lane % 4;

  int hslot = 0, hround = 0, wslot = 0, wround = 0;
  for (int tile = sub; tile < p.tiles; tile += p.bps) {
    float acc[MW][NW][4];
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int cc = 0; cc < p.chunks; ++cc) {
      mbar_wait(halo_full + hslot, (unsigned)(hround & 1));
      const uint8_t* const hb = halo + (long long)hslot * p.halo_bytes;
      const int rest = (p.c - cc * kChunkCh) * (int)sizeof(T);
      const int ksteps = (rest < kChunkBytes ? rest : kChunkBytes) / kStepBytes;
      for (int ky = 0; ky < p.kh; ++ky)
        for (int kx = 0; kx < p.kw; ++kx) {
          const int tap = ky * p.kw + kx;
          const int slot = p.resident ? cc * p.taps + tap : wslot;
          // resident chunks arrive in one box, waited for in the block's first tile
          if (!p.resident || tile == sub)
            mbar_wait(w_full + (p.resident ? 0 : slot), (unsigned)(wround & 1));
          const uint8_t* const wb = wsm + (long long)slot * p.w_bytes;
          const uint8_t* const ab = hb + (ky * p.hw + kx) * kPixBytes;
          for (int ks = 0; ks < ksteps; ++ks) {
            const int gran = ((2 * ks + b_half) ^ b_swz) * 16;
            unsigned bh[NW + 1][2], bl[NW + 1][2];
#pragma unroll
            for (int q = 0; q < (NW + 1) / 2; ++q) {
              unsigned r[4];
              ldsm_x4(r, wb + b_row[q] + gran);
              bh[2 * q][0] = r[0];
              bh[2 * q][1] = r[1];
              bh[2 * q + 1][0] = r[2];
              bh[2 * q + 1][1] = r[3];
              if (kF32) {
                ldsm_x4(r, wb + b_row[q] + p.bn * kChunkBytes + gran);
                bl[2 * q][0] = r[0];
                bl[2 * q][1] = r[1];
                bl[2 * q + 1][0] = r[2];
                bl[2 * q + 1][1] = r[3];
              }
            }
#pragma unroll
            for (int i = 0; i < MW; ++i) {
              unsigned a[4];
              ldsm_x4(a, ab + a_off[i] + ks * kStepBytes);
              if (kF32) {
                unsigned ah[4], al[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) split_tf32(ah[e], al[e], a[e]);
#pragma unroll
                for (int j = 0; j < NW; ++j) {
                  mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
                  mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
                  mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
                }
              } else {
#pragma unroll
                for (int j = 0; j < NW; ++j) mma_bf16(acc[i][j], a, bh[j][0], bh[j][1]);
              }
            }
          }
          if (!p.resident) {
            __syncwarp();
            if (lane == 0) mbar_arrive(w_empty + wslot);  // this warp is done with the chunk
            if (++wslot == p.ws) wslot = 0, ++wround;
          }
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(halo_empty + hslot);  // this warp is done with the halo
      if (++hslot == p.hs) hslot = 0, ++hround;
    }

    // acc[i][j][2e + q]: pixel g + 8e of m16 tile i, output 8 (j0 + j) + 2t + q
    const TileAt t = tile_at(p, tile);
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = (mp * MW + i) * 16 + gq + 8 * e;
        const int img = t.img + m / tile_px, oh = t.h0 + m / p.tw % p.th, ow = t.w0 + m % p.tw;
        if (img >= p.n || oh >= p.ho || ow >= p.wo) continue;
        T* const yp = y + ((((long long)grp * p.n + img) * p.ho + oh) * p.wo + ow) * p.f;
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int nl = 8 * (j0 + j) + 2 * tq + q;
            if (f0 + nl < p.f) yp[f0 + nl] = from_f32<T>(acc[i][j][2 * e + q] + bias_s[nl]);
          }
      }
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

// the slots of a slice of `bn` outputs beside 2 halo slots: every weight
// chunk resident (one TMA box: at most 256 chunks), else streamed weight
// slots (at least 2): as many as fit, or as many as leave room for a second
// block on the SM where kPairSlots of them do (a block's warps each carry
// few accumulators, so two blocks hide each other's product latency). False
// if not even 2 fit.
bool fit_slots(FwdPlan& p, int bn, int elem) {
  p.w_bytes = (elem == 4 ? 2 : 1) * bn * kChunkBytes;
  const int bias = round_up(4 * bn, 128);
  const auto bytes = [&](int hs, int ws) {
    return round_up(8 * (2 * hs + 2 * ws), 128) + bias + ws * p.w_bytes + hs * p.halo_bytes;
  };
  p.hs = 2;
  if (p.wchunks <= 256 && bytes(2, p.wchunks) <= kSmemLimit) {
    p.resident = 1;
    p.ws = p.wchunks;
    return true;
  }
  p.resident = 0;
  p.ws = 0;
  const int limit = bytes(2, kPairSlots) <= kPairSmem ? kPairSmem : kSmemLimit;
  for (int ws = 2; ws <= kMaxSlots && ws < p.wchunks && bytes(2, ws) <= limit; ++ws)
    p.ws = ws;
  return p.ws >= 2;
}

// n8 tiles a warp for `ntb` n8 tiles over at most `ng_max` warps a row of
// m16 tiles: an instance's count (1, 2, 3, 4 or 6) that splits them evenly
// over the most warps; 0 if none does
int warp_split(int ntb, int ng_max) {
  for (int ngroups = ntb < ng_max ? ntb : ng_max; ngroups >= 1; --ngroups) {
    const int nw = ntb / ngroups;
    if (ntb % ngroups == 0 && (nw <= 4 || nw == 6)) return nw;
  }
  return 0;
}

template <typename T>
int plan_fwd(FwdPlan& p, const Shape& s, int groups, int sms) {
  constexpr int e = (int)sizeof(T);
  p = FwdPlan{};
  p.groups = groups;
  p.n = s.n;
  p.h = s.h;
  p.w = s.w;
  p.c = s.c;
  p.kh = s.kh;
  p.kw = s.kw;
  p.f = s.f;
  p.pt = s.pt;
  p.pl = s.pl;
  p.ho = s.ho;
  p.wo = s.wo;
  // the tile, shaped like the output
  p.tn = 1;
  if (s.ho == 1 && s.wo == 1) {
    p.th = p.tw = 1;
    p.tn = 16;
  } else if (s.ho == 1) {
    p.th = 1;
    p.tw = kStripPx;
  } else if (s.wo == 1) {
    p.th = kStripPx;
    p.tw = 1;
  } else {
    p.th = e == 4 ? 16 : 8;
    p.tw = 16;
  }
  p.hh = p.th + s.kh - 1;
  p.hw = p.tw + s.kw - 1;
  if (p.hh > 256 || p.hw > 256) return cudaErrorInvalidValue;  // a TMA box side
  p.tiles_w = cdiv(s.wo, p.tw);
  p.tiles_h = cdiv(s.ho, p.th);
  p.tiles = cdiv(s.n, p.tn) * p.tiles_h * p.tiles_w;
  const int mt = p.th * p.tw * p.tn / 16;
  // a warp's m16 tiles: kMW in the interior; kStripMW in a strip or corner
  // tile, whose few tiles and outputs a block leave the card more warps
  p.mw = s.ho == 1 || s.wo == 1 ? kStripMW : kMW;
  if (p.mw > mt) p.mw = 1;
  p.mpairs = mt / p.mw;
  const int ng_max = kWarps / p.mpairs > 1 ? kWarps / p.mpairs : 1;
  p.chunks = cdiv(s.c * e, kChunkBytes);
  p.taps = s.kh * s.kw;
  p.wchunks = p.chunks * p.taps;
  p.halo_tx = p.tn * p.hh * p.hw * kPixBytes;
  p.halo_bytes = round_up(p.halo_tx, 128);
  // the outputs of a slice: the most (up to kNW n8 tiles a warp and a TMA
  // box's 256 rows) that still give every SM a block, among those that fit
  // and whose n8 tiles split evenly over the warps
  int bn = round_up(s.f, 8);
  if (bn > 8 * kNW * ng_max) bn = 8 * kNW * ng_max;
  if (bn > 256) bn = 256;
  for (; bn >= 8; bn -= 8) {
    if (bn > 8 && (long long)groups * cdiv(s.f, bn) * p.tiles < sms) continue;
    if (warp_split(bn / 8, ng_max) && fit_slots(p, bn, e)) break;
  }
  if (bn < 8) return cudaErrorInvalidValue;
  p.bn = bn;
  p.ntb = bn / 8;
  p.nw = warp_split(p.ntb, ng_max);
  p.warps = p.mpairs * (p.ntb / p.nw);
  p.nblocks = cdiv(s.f, bn);
  p.off_bias = round_up(8 * (2 * p.hs + 2 * p.ws), 128);
  p.off_w = p.off_bias + round_up(4 * bn, 128);
  p.off_halo = p.off_w + p.ws * p.w_bytes;
  p.smem_bytes = p.off_halo + p.hs * p.halo_bytes;
  return cudaSuccess;
}

// the launch of the (MW, NW) instance: its grid, the blocks the card holds
// at once spread over the slices
template <typename T, int MW, int NW>
int launch_tc(const void* bias, void* y, FwdPlan& p, const CUtensorMap& x_map,
              const CUtensorMap& w_map, void* stream) {
  auto kernel = conv_kxk_tc_kernel<T, MW, NW>;
  static std::atomic<unsigned long long> limit_set{0};
  const cudaError_t attr = smem_limit_once(limit_set, kernel, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const int threads = 32 * (p.warps + 1);
  long long card = 0;
  const int err = resident_blocks(kernel, threads, p.smem_bytes, &card);
  if (err) return err;
  const long long slices = (long long)p.groups * p.nblocks;
  const long long per_slice = (card + slices - 1) / slices;
  p.bps = (int)(per_slice < p.tiles ? per_slice : p.tiles);
  kernel<<<(unsigned)(slices * p.bps), threads, p.smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bias), static_cast<T*>(y), p, x_map, w_map);
  return (int)cudaGetLastError();
}

// G problems of one shape: x (G n, h, w, c) and y (G n, ho, wo, f)
// contiguous; w the wrapper's chunked weight operand (ops/conv_kxk.py
// `chunked_weight`) for each problem, stacked; bias (G, f) f32
template <typename T>
int conv_kxk_tc(const void* x, const void* w, const void* bias, void* y, int groups, int n,
                int h, int w_img, int c, int kh, int kw, int f, int pt, int pb, int pl, int pr,
                void* stream) {
  constexpr int e = (int)sizeof(T);
  Shape s;
  const int refused = make_shape(s, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr);
  if (refused) return refused;
  if (c % 16 || groups <= 0 || (long long)groups * n > (1 << 30)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(w)) % 16)
    return cudaErrorMisalignedAddress;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  FwdPlan p;
  // the plan's choice of outputs a slice counts one block an SM
  err = plan_fwd<T>(p, s, groups, sms);
  if (err) return err;
  CUtensorMap x_map, w_map;
  const cuuint64_t xd[4] = {(cuuint64_t)c, (cuuint64_t)w_img, (cuuint64_t)h,
                            (cuuint64_t)groups * n};
  const cuuint64_t xs[3] = {(cuuint64_t)c * e, (cuuint64_t)w_img * c * e,
                            (cuuint64_t)h * w_img * c * e};
  const cuuint32_t xb[4] = {(cuuint32_t)(kPixBytes / e), (cuuint32_t)p.hw, (cuuint32_t)p.hh,
                            (cuuint32_t)p.tn};
  err = tensor_map(&x_map, kMapType<T>, x, xd, xs, xb);
  if (err) return err;
  const int planes = e == 4 ? 2 : 1;  // f32: hi, lo
  const cuuint64_t wd[4] = {(cuuint64_t)(kChunkBytes / e), (cuuint64_t)f, (cuuint64_t)planes,
                            (cuuint64_t)groups * p.wchunks};
  const cuuint64_t wst[3] = {(cuuint64_t)kChunkBytes, (cuuint64_t)f * kChunkBytes,
                             (cuuint64_t)planes * f * kChunkBytes};
  // resident: the slice's chunks in one box; else one chunk a box
  const cuuint32_t wb[4] = {(cuuint32_t)(kChunkBytes / e), (cuuint32_t)p.bn,
                            (cuuint32_t)planes, (cuuint32_t)(p.resident ? p.wchunks : 1)};
  err = tensor_map(&w_map, kMapType<T>, w, wd, wst, wb);
  if (err) return err;
  const auto go = [&](auto mw, auto nw) {
    return launch_tc<T, decltype(mw)::value, decltype(nw)::value>(bias, y, p, x_map, w_map,
                                                                   stream);
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using Three = std::integral_constant<int, 3>;
  using Four = std::integral_constant<int, 4>;
  using Six = std::integral_constant<int, 6>;
  switch (p.mw * 8 + p.nw) {
    case 8 + 1: return go(One(), One());
    case 8 + 2: return go(One(), Two());
    case 8 + 3: return go(One(), Three());
    case 8 + 4: return go(One(), Four());
    case 8 + 6: return go(One(), Six());
    case 16 + 1: return go(Two(), One());
    case 16 + 2: return go(Two(), Two());
    case 16 + 3: return go(Two(), Three());
    case 16 + 4: return go(Two(), Four());
    case 16 + 6: return go(Two(), Six());
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int conv_kxk_cc(const void* x, const void* w, const void* bias, void* y, int groups, int n,
                int h, int w_img, int c, int kh, int kw, int f, int pt, int pb, int pl, int pr,
                void* stream) {
  Shape s;
  const int refused = make_shape(s, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr);
  if (refused) return refused;
  if (groups <= 0 || groups > 65535) return cudaErrorInvalidValue;
  const long long total = (long long)s.n * s.ho * s.wo * s.f;
  const dim3 grid((unsigned)((total + kCcThreads - 1) / kCcThreads), (unsigned)groups);
  conv_kxk_cc_kernel<T><<<grid, kCcThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

// ---- tensor-core weight gradient (C % 16 == 0, kh kw <= 25) ----

constexpr int kWgTH = 8;                       // pixel rows of a tile
constexpr int kWgTW = 16;                      // pixel columns of a tile: one bf16 k-step
constexpr int kWgPix = kWgTH * kWgTW;
constexpr int kWgKC = 16;                      // channels of a block: one m16 tile a tap
constexpr int kWgWarps = 5;
constexpr int kWgThreads = 32 * kWgWarps;
constexpr int kWgMW = 5;                       // taps (m16 tiles) of a warp: tap = warp + 5 i
constexpr int kWgNT = 6;                       // n8 tiles of a block: 48 outputs
constexpr int kWgHaloLd = 24;                  // elements between halo pixels (f32 == 8 mod 16;
                                               // bf16 48 bytes, an odd multiple of 16)

struct WgPlan {
  int n, h, w, c, kh, kw, f, pt, pl, ho, wo;
  int tiles_w, tiles_h, tiles;
  int bn, nt, nblocks, hh, hw;
  int g_ld, stage;  // elements between g pixels; elements of a stage (halo, then g)
  int g_vec;        // g's rows are whole 16-byte granules
};

// Block (channel chunk, output block) = blockIdx.x, split blockIdx.z: pixel
// tiles [z chunk, min((z + 1) chunk, tiles)) of the output. Writes rows tap
// C + c0 .. + 16 of the split's partial for outputs f0 .. f0 + 8 NT, and the
// db row from the blocks of channel chunk 0. The warp index comes through a
// shuffle, so a warp's tap bound is known to be the same across it.
template <typename T, int NT>
__global__ void __launch_bounds__(kWgThreads, 2)
    conv_kxk_wgrad_tc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             float* __restrict__ ws, WgPlan p, int chunk) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kGran = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(128) float4 kxk_wg_smem[];
  T* const smem = reinterpret_cast<T*>(kxk_wg_smem);
  const int cc = blockIdx.x / p.nblocks;
  const int c0 = cc * kWgKC;
  const int f0 = blockIdx.x % p.nblocks * p.bn;
  const long long t_begin = (long long)blockIdx.z * chunk;
  const long long t_end = p.tiles < t_begin + chunk ? p.tiles : t_begin + chunk;
  const int taps = p.kh * p.kw;
  const int rows = taps * p.c + 1;
  const int tid = threadIdx.x;

  const auto copy_tile = [&](long long tile, int stage) {
    T* const halo = smem + stage * p.stage;
    T* const gt = halo + p.hh * p.hw * kWgHaloLd;
    const long long img = tile / (p.tiles_w * p.tiles_h);
    const int h0 = (int)(tile / p.tiles_w % p.tiles_h) * kWgTH;
    const int w0 = (int)(tile % p.tiles_w) * kWgTW;
    const T* const x_img = x + img * p.h * p.w * p.c;
    constexpr int kXg = kWgKC / kGran;
    for (int e = tid; e < p.hh * p.hw * kXg; e += kWgThreads) {
      const int px = e / kXg, q = e % kXg;
      const int ih = h0 - p.pt + px / p.hw, iw = w0 - p.pl + px % p.hw;
      const bool inside = ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
      cp_async16(halo + px * kWgHaloLd + q * kGran,
                 inside ? x_img + ((long long)ih * p.w + iw) * p.c + c0 + q * kGran : x, !inside);
    }
    const T* const g_img = g + img * p.ho * p.wo * p.f;
    if (p.g_vec) {
      const int groups = p.bn / kGran;
      for (int e = tid; e < kWgPix * groups; e += kWgThreads) {
        const int px = e / groups, q = e % groups;
        const int oh = h0 + px / kWgTW, ow = w0 + px % kWgTW, ff = f0 + q * kGran;
        const bool inside = oh < p.ho && ow < p.wo && ff < p.f;
        cp_async16(gt + px * p.g_ld + q * kGran,
                   inside ? g_img + ((long long)oh * p.wo + ow) * p.f + ff : g, !inside);
      }
    } else {
      for (int e = tid; e < kWgPix * p.bn; e += kWgThreads) {
        const int px = e / p.bn, col = e % p.bn;
        const int oh = h0 + px / kWgTW, ow = w0 + px % kWgTW, ff = f0 + col;
        gt[px * p.g_ld + col] = oh < p.ho && ow < p.wo && ff < p.f
                                    ? g_img[((long long)oh * p.wo + ow) * p.f + ff]
                                    : from_f32<T>(0.f);
      }
    }
  };

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  // the warp's taps: warp + kWgWarps i for i < m_tiles, each a shift of the
  // halo by tap_off[i] elements
  const int m_tiles = taps > warp ? (taps - warp + kWgWarps - 1) / kWgWarps : 0;
  int tap_off[kWgMW];
#pragma unroll
  for (int i = 0; i < kWgMW; ++i) {
    const int tap = warp + kWgWarps * i;
    tap_off[i] = (tap / p.kw * p.hw + tap % p.kw) * kWgHaloLd;
  }
  // db: column db_col of the g tile, pixels db_run, + db_runs, ...
  const int db_runs = kWgThreads / p.bn;
  const int db_col = tid % p.bn, db_run = tid / p.bn;
  const bool db_live = cc == 0 && db_run < db_runs && f0 + db_col < p.f;
  float db_acc = 0.f;

  float acc[kWgMW][NT][4];
#pragma unroll
  for (int i = 0; i < kWgMW; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
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
    const T* const halo = smem + stage * p.stage;
    const T* const gt = halo + p.hh * p.hw * kWgHaloLd;
    if (db_live)
      for (int px = db_run; px < kWgPix; px += db_runs) db_acc += to_f32(gt[px * p.g_ld + db_col]);
    if (kF32) {
      const unsigned* const hw32 = reinterpret_cast<const unsigned*>(halo);
      const unsigned* const gw32 = reinterpret_cast<const unsigned*>(gt);
#pragma unroll 1
      for (int ks = 0; ks < kWgPix / 8; ++ks) {
        // k-step: pixels px0 .. px0 + 8 of tile row py
        const int py = ks / 2, px0 = ks % 2 * 8;
        const unsigned* const gb = gw32 + (py * kWgTW + px0) * p.g_ld;
        unsigned bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_tf32(bh[j][0], bl[j][0], gb[tq * p.g_ld + 8 * j + gq]);
          split_tf32(bh[j][1], bl[j][1], gb[(tq + 4) * p.g_ld + 8 * j + gq]);
        }
#pragma unroll
        for (int i = 0; i < kWgMW; ++i) {
          if (i >= m_tiles) break;
          const unsigned* const ab = hw32 + (py * p.hw + px0) * kWgHaloLd + tap_off[i];
          unsigned ah[4], al[4];
          split_tf32(ah[0], al[0], ab[tq * kWgHaloLd + gq]);
          split_tf32(ah[1], al[1], ab[tq * kWgHaloLd + gq + 8]);
          split_tf32(ah[2], al[2], ab[(tq + 4) * kWgHaloLd + gq]);
          split_tf32(ah[3], al[3], ab[(tq + 4) * kWgHaloLd + gq + 8]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
            mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
            mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
          }
        }
      }
    } else {
      // ldmatrix.trans rows: A's matrix lane / 8 is channels 8 (mi % 2) .. of
      // pixels 8 (mi / 2) ..; B's pair member lane / 16, pixels 8 (mi % 2) ..
      const int mi = lane / 8;
      const int a_lane = (8 * (mi / 2) + lane % 8) * kWgHaloLd + 8 * (mi % 2);
      const int b_px = 8 * (mi % 2) + lane % 8;
#pragma unroll 1
      for (int py = 0; py < kWgTH; ++py) {
        // k-step: the 16 pixels of tile row py
        unsigned b[NT + 1][2];
#pragma unroll
        for (int q = 0; q < (NT + 1) / 2; ++q) {
          int jj = 2 * q + lane / 16;
          jj = jj < NT ? jj : NT - 1;  // a pair's missing half reads a real column
          unsigned r[4];
          ldsm_x4_trans(r, gt + (py * kWgTW + b_px) * p.g_ld + 8 * jj);
          b[2 * q][0] = r[0];
          b[2 * q][1] = r[1];
          b[2 * q + 1][0] = r[2];
          b[2 * q + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < kWgMW; ++i) {
          if (i >= m_tiles) break;
          unsigned a[4];
          ldsm_x4_trans(a, halo + py * p.hw * kWgHaloLd + tap_off[i] + a_lane);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  float* const part = ws + (long long)blockIdx.z * rows * p.f;
#pragma unroll
  for (int i = 0; i < kWgMW; ++i) {
    if (i >= m_tiles) break;
    const int tap = warp + kWgWarps * i;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ff = f0 + 8 * j + 2 * tq + q;
          if (ff < p.f)
            part[(long long)(tap * p.c + c0 + gq + 8 * e) * p.f + ff] = acc[i][j][2 * e + q];
        }
    }
  }
  if (cc == 0) {
    float* const scratch = reinterpret_cast<float*>(kxk_wg_smem);
    if (db_run < db_runs) scratch[db_run * p.bn + db_col] = db_acc;
    __syncthreads();
    if (tid < p.bn && f0 + tid < p.f) {
      float sum = 0.f;
      for (int r = 0; r < db_runs; ++r) sum += scratch[r * p.bn + tid];
      part[(long long)(rows - 1) * p.f + f0 + tid] = sum;
    }
  }
}

// ---- CUDA-core weight gradient (any shape) ----

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
    conv_kxk_sum_splits_kernel(const float* __restrict__ ws, float* __restrict__ out,
                               long long size, int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= size) return;
  float v = ws[i];
  for (int z = 1; z < splits; ++z) v += ws[(long long)z * size + i];
  out[i] = v;
}

int sum_splits(const void* ws, void* out, long long size, int splits, void* stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv_kxk_sum_splits_kernel<<<(unsigned)((size + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), size, splits);
  return (int)cudaGetLastError();
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
  const dim3 grid((unsigned)((rows + kGR - 1) / kGR), (unsigned)((f + kGF - 1) / kGF),
                  (unsigned)splits);
  conv_kxk_wgrad_kernel<T><<<grid, kGThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(ws), s, chunk);
  return sum_splits(ws, out, (long long)rows * f, splits, stream);
}

template <typename T, int NT>
int launch_wgrad_tc(const void* x, const void* g, void* ws, const WgPlan& p, int chunk,
                    dim3 grid, int smem, void* stream) {
  auto kernel = conv_kxk_wgrad_tc_kernel<T, NT>;
  static std::atomic<unsigned long long> limit_set{0};
  const cudaError_t attr = smem_limit_once(limit_set, kernel, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(ws), p, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_kxk_wgrad_tc(const void* x, const void* g, void* ws, void* out, int n, int h,
                      int w_img, int c, int kh, int kw, int f, int pt, int pb, int pl, int pr,
                      int splits, int chunk, void* stream) {
  constexpr int e = (int)sizeof(T);
  Shape s;
  const int refused = make_shape(s, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr);
  if (refused) return refused;
  if (c % kWgKC || kh * kw > kWgWarps * kWgMW) return cudaErrorInvalidValue;
  if ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(g)) % 16)
    return cudaErrorMisalignedAddress;
  WgPlan p{};
  p.n = n;
  p.h = h;
  p.w = w_img;
  p.c = c;
  p.kh = kh;
  p.kw = kw;
  p.f = f;
  p.pt = pt;
  p.pl = pl;
  p.ho = s.ho;
  p.wo = s.wo;
  p.tiles_w = cdiv(s.wo, kWgTW);
  p.tiles_h = cdiv(s.ho, kWgTH);
  const long long tiles = (long long)n * p.tiles_w * p.tiles_h;
  if (tiles >= (1ll << 31) || (long long)kh * kw * c + 1 >= (1ll << 31) / f)
    return cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  // every split must hold tiles: none empty, none past the end
  if (splits <= 0 || splits > 65535 || chunk <= 0 || (long long)(splits - 1) * chunk >= tiles ||
      (long long)splits * chunk < tiles)
    return cudaErrorInvalidValue;
  p.nblocks = cdiv(f, 8 * kWgNT);
  p.bn = round_up(cdiv(f, p.nblocks), 8);
  p.nt = p.bn / 8;
  p.hh = kWgTH + kh - 1;
  p.hw = kWgTW + kw - 1;
  // g's pixel stride: f32 == 8 (mod 16) words, bf16 an odd multiple of 16 bytes
  p.g_ld = p.bn + (e == 4 ? 4 : 8);
  while (e == 4 ? p.g_ld % 16 != 8 : (p.g_ld / 8) % 2 == 0) p.g_ld += e == 4 ? 4 : 8;
  p.stage = p.hh * p.hw * kWgHaloLd + kWgPix * p.g_ld;
  p.g_vec = (f * e) % 16 == 0;
  const int smem = 2 * p.stage * e;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(c / kWgKC * p.nblocks), 1, (unsigned)splits);
  int err = cudaErrorInvalidValue;
  switch (p.nt) {
    case 1: err = launch_wgrad_tc<T, 1>(x, g, ws, p, chunk, grid, smem, stream); break;
    case 2: err = launch_wgrad_tc<T, 2>(x, g, ws, p, chunk, grid, smem, stream); break;
    case 3: err = launch_wgrad_tc<T, 3>(x, g, ws, p, chunk, grid, smem, stream); break;
    case 4: err = launch_wgrad_tc<T, 4>(x, g, ws, p, chunk, grid, smem, stream); break;
    case 5: err = launch_wgrad_tc<T, 5>(x, g, ws, p, chunk, grid, smem, stream); break;
    case 6: err = launch_wgrad_tc<T, 6>(x, g, ws, p, chunk, grid, smem, stream); break;
  }
  if (err) return err;
  return sum_splits(ws, out, (long long)(kh * kw * c + 1) * f, splits, stream);
}

}  // namespace

// Plain C entry points for ctypes. The launches go on `stream` and do not
// synchronise; the return value is cudaGetLastError() right after the
// launch (0 = launched), or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// for what an entry does not take, with nothing launched.
//
// CUDA-core forward: x (n, h, w, c) contiguous; w the kernel as [kh kw][f][c]
// contiguous in the dtype of x (ops/conv_kxk.py `entry_weight`); bias (f,)
// f32; y (n, ho, wo, f) with ho = h + pt + pb - kh + 1, wo = w + pl + pr - kw
// + 1. The grouped entries take G such problems stacked: x (G, n, h, w, c),
// w (G, kh kw, f, c), bias (G, f), y (G, n, ho, wo, f).
extern "C" int conv_kxk_f32(const void* x, const void* w, const void* bias, void* y, int n,
                            int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                            int pl, int pr, void* stream) {
  return conv_kxk_cc<float>(x, w, bias, y, 1, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                            stream);
}

extern "C" int conv_kxk_bf16(const void* x, const void* w, const void* bias, void* y, int n,
                             int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                             int pl, int pr, void* stream) {
  return conv_kxk_cc<__nv_bfloat16>(x, w, bias, y, 1, n, h, w_img, c, kh, kw, f, pt, pb, pl,
                                    pr, stream);
}

extern "C" int conv_kxk_group_f32(const void* x, const void* w, const void* bias, void* y,
                                  int groups, int n, int h, int w_img, int c, int kh, int kw,
                                  int f, int pt, int pb, int pl, int pr, void* stream) {
  return conv_kxk_cc<float>(x, w, bias, y, groups, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                            stream);
}

extern "C" int conv_kxk_group_bf16(const void* x, const void* w, const void* bias, void* y,
                                   int groups, int n, int h, int w_img, int c, int kh, int kw,
                                   int f, int pt, int pb, int pl, int pr, void* stream) {
  return conv_kxk_cc<__nv_bfloat16>(x, w, bias, y, groups, n, h, w_img, c, kh, kw, f, pt, pb,
                                    pl, pr, stream);
}

// Tensor-core forward: C a multiple of 16; x and w 16-byte aligned; w the
// wrapper's chunked operand (ops/conv_kxk.py `chunked_weight`: [channel
// chunk][kh kw][hi, lo for f32][f][128 bytes of channels], each row's
// 16-byte granules swizzled by the row); the rest as the CUDA-core entries'.
// The grouped entries take G problems stacked as there.
extern "C" int conv_kxk_f32_tc(const void* x, const void* w, const void* bias, void* y, int n,
                               int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                               int pl, int pr, void* stream) {
  return conv_kxk_tc<float>(x, w, bias, y, 1, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                            stream);
}

extern "C" int conv_kxk_bf16_tc(const void* x, const void* w, const void* bias, void* y, int n,
                                int h, int w_img, int c, int kh, int kw, int f, int pt, int pb,
                                int pl, int pr, void* stream) {
  return conv_kxk_tc<__nv_bfloat16>(x, w, bias, y, 1, n, h, w_img, c, kh, kw, f, pt, pb, pl,
                                    pr, stream);
}

extern "C" int conv_kxk_group_f32_tc(const void* x, const void* w, const void* bias, void* y,
                                     int groups, int n, int h, int w_img, int c, int kh, int kw,
                                     int f, int pt, int pb, int pl, int pr, void* stream) {
  return conv_kxk_tc<float>(x, w, bias, y, groups, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                            stream);
}

extern "C" int conv_kxk_group_bf16_tc(const void* x, const void* w, const void* bias, void* y,
                                      int groups, int n, int h, int w_img, int c, int kh,
                                      int kw, int f, int pt, int pb, int pl, int pr,
                                      void* stream) {
  return conv_kxk_tc<__nv_bfloat16>(x, w, bias, y, groups, n, h, w_img, c, kh, kw, f, pt, pb,
                                    pl, pr, stream);
}

// The weight gradient: x (n, h, w, c) and g (n, ho, wo, f) contiguous, of
// one dtype; ws: (splits, kh kw c + 1, f) f32 scratch; out: (kh kw c + 1, f)
// f32, dW as the HWIO kernel reshaped to (kh kw c, f), then db. The
// CUDA-core entries cut the output pixels into `splits` runs of `chunk`;
// the tensor-core entries (C % 16 == 0, kh kw <= 25, x and g 16-byte
// aligned) cut the output's 8 x 16 pixel tiles (along W, then H, then
// images) into `splits` runs of `chunk` tiles. No run is empty.
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

extern "C" int conv_kxk_wgrad_f32_tc(const void* x, const void* g, void* ws, void* out, int n,
                                     int h, int w_img, int c, int kh, int kw, int f, int pt,
                                     int pb, int pl, int pr, int splits, int chunk,
                                     void* stream) {
  return conv_kxk_wgrad_tc<float>(x, g, ws, out, n, h, w_img, c, kh, kw, f, pt, pb, pl, pr,
                                  splits, chunk, stream);
}

extern "C" int conv_kxk_wgrad_bf16_tc(const void* x, const void* g, void* ws, void* out, int n,
                                      int h, int w_img, int c, int kh, int kw, int f, int pt,
                                      int pb, int pl, int pr, int splits, int chunk,
                                      void* stream) {
  return conv_kxk_wgrad_tc<__nv_bfloat16>(x, g, ws, out, n, h, w_img, c, kh, kw, f, pt, pb,
                                          pl, pr, splits, chunk, stream);
}
