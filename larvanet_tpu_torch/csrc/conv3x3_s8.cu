// One conv of the W8A8 int8 conv pair: a SAME 3x3 convolution of int8
// codes, NHWC x the pair's int8 weights, with int32 sums on the tensor cores
// (mma.sync s8 x s8 -> s32), for Hopper.
//
// Replaces no TPU kernel: in the JAX package the int8 pair's convs are XLA's
// `lax.conv_general_dilated` on int8 with int32 results
// (larvanet_tpu/ops/packed/pairs.py:236-250, `pair_int8`). The pair is
//
//   xq = clip(rint(f32(hin) / s_in), -127, 127)                 (int8)
//   t  = act(T(T(f32(conv(xq, ka)) * sca[f]) + ba[f]))           (conv_a)
//   tq = clip(rint(f32(t) / s_mid), -127, 127)                  (int8)
//   t  = T(T(f32(conv(tq, kb)) * scb[f]) + bb[f])                (conv_b)
//   t  = T(t * T(res_weight)) when res_weight != 1; out = T(hin + t) or t
//
// with T the residual stream's dtype (f32 or bf16), sca = f32(s_in) * sa and
// scb = f32(s_mid) * sb the host's per-channel f32 products, rint half to
// even. Two entries of one kernel: `conv3x3_s8_a_*` takes hin in T and
// quantizes it as it stages it into shared memory, and its epilogue ends in
// the requantize to int8; `conv3x3_s8_b_*` takes tq in int8 and its
// epilogue ends in T, with the optional res_weight and residual add. The
// int32 sums are exact in any order (|acc| <= 9 C 127^2), f32(acc) is exact
// below 2^24 and rounds to nearest even above, and every later step is one
// IEEE operation in the order above (__fmul_rn, __fadd_rn and __fdiv_rn,
// which nvcc neither contracts into an FMA nor replaces by a reciprocal), so
// the kernel equals its plain version (ops/conv3x3_s8.py) and JAX's pair bit
// for bit. Build without --use_fast_math.
//
// Design (simple first; see PERF.md for its time against its bound): an
// implicit GEMM on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. A block
// owns a tile of kTH x kTW = 16 x 16 output pixels of one image and kBN = 64
// output channels (blockIdx.y); each of its 8 warps owns 2 rows of 16 pixels
// x the 64 outputs, 16 accumulator tiles of m16n8 in registers. The input
// channels go in chunks of kKC = 32 (C is padded to a multiple of 32 with
// zero codes): per chunk the block stages the tile's halo ((kTH + 2) x (kTW +
// 2) pixels x 32 codes, zero outside the image: the SAME padding) and the
// chunk's weights (9 taps x 64 outputs x 32 codes, the wrapper's [9][Fp][Cp]
// layout, F padded to 64 with zero rows) into shared memory, then runs the
// 9 taps with no barrier: an A operand (16 pixels x 32 codes) comes by one
// ldmatrix.x4 straight from the halo at the tap's shift, the B operands of
// two n8 tiles by another, both read as 8 x 8 b16 matrices (16 bytes a row);
// rows of both sit 48 bytes apart, an odd multiple of 16, so the 8 rows of an
// ldmatrix phase fall in distinct banks. The epilogue works from the
// accumulators' registers and stores one value at a time. What it leaves on
// the table: the staging is synchronous (no cp.async ring), conv_a's input is
// quantized once per tile and chunk (the halo's 1.27x re-reads), padded
// channels and outputs are multiplied, and mma.sync runs s8 at a fraction of
// wgmma's rate (queue 2 of ROADMAP.md: wgmma s8 fed by TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTH = 16;               // output rows of a tile
constexpr int kTW = 16;               // output columns of a tile: one m16 operand
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRW = kTH / kWarps;     // output rows of a warp
constexpr int kBN = 64;               // output channels of a block
constexpr int kNT = kBN / 8;          // n8 tiles of a warp
constexpr int kKC = 32;               // input channels (codes) of a chunk: one k32 step
constexpr int kLd = kKC + 16;         // bytes a staged row: 48, an odd multiple of 16
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPix = (kTH + 2) * kHaloW;
constexpr int kSmemBytes = (kHaloPix + 9 * kBN) * kLd;  // 43,200 bytes

struct S8Shape {
  int n, h_img, w_img, c, f, cp, fp, h_tiles, w_tiles;
};

// the epilogue's scalars: conv_a's s_in and s_mid; conv_b's res_weight
struct S8Scalars {
  float s_in, s_mid, res_weight;
  int act;     // conv_a: 0 none, 1 relu
  int use_rw;  // conv_b: multiply by res_weight
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// v rounded to T and back: the value a T holds
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// clip(rint(v / s), -127, 127): an IEEE division, round half to even
__device__ __forceinline__ int quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// the code of input value v: conv_a quantizes hin, conv_b's input is codes
__device__ __forceinline__ int code_of(int8_t v, float) { return v; }
template <typename T>
__device__ __forceinline__ int code_of(T v, float s_in) {
  return quantize(to_f32(v), s_in);
}

// ldmatrix.x4 from shared memory: lane l names row l % 8 of 8 x 8 b16 matrix
// l / 8 and receives, from matrix i, its bytes (l / 4, 4 (l % 4) .. + 3) in
// r[i]: as s8, row g = l / 4 and the four codes 4t .. 4t + 3, t = l % 4
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const int8_t* row) {
#ifdef __CUDA_ARCH__
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
#elif !defined(__CUDACC__)
  emu_ldmatrix_x4(r, row);  // the CPU stand-in (ops/emulate.py)
#endif
}

// d += a x b on mma.sync.m16n8k32 s8, s32 sums, in the PTX ISA's layouts (g =
// lane / 4, t = lane % 4): a[0] holds A(g, 4t .. 4t + 3), a[1] A(g + 8, 4t ..),
// a[2] A(g, 16 + 4t ..), a[3] A(g + 8, 16 + 4t ..); b0 B(4t .. 4t + 3; g), b1
// B(16 + 4t ..; g); d[2e + i] is D(g + 8e, 2t + i)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#elif !defined(__CUDACC__)
  emu_mma_m16n8k32_s8(d, a, b0, b1);
#endif
}

// Block (tile, f0 = kBN blockIdx.y): tiles run along W, then H, then images.
// Tin is the input (T for conv_a, int8_t for conv_b); Tout the output (int8_t
// for conv_a, T for conv_b); T the residual stream's dtype.
template <typename Tin, typename Tout, typename T, bool kA>
__global__ void __launch_bounds__(kThreads)
    conv3x3_s8_kernel(const Tin* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      const T* __restrict__ res, Tout* __restrict__ y, S8Shape s,
                      S8Scalars k) {
  extern __shared__ __align__(128) int8_t s8_smem[];
  int8_t* const halo = s8_smem;               // [kHaloPix][kLd]
  int8_t* const slab = s8_smem + kHaloPix * kLd;  // [9][kBN][kLd]

  const long long tile = blockIdx.x;
  const long long img = tile / ((long long)s.h_tiles * s.w_tiles);
  const int h0 = (int)(tile / s.w_tiles % s.h_tiles) * kTH;
  const int w0 = (int)(tile % s.w_tiles) * kTW;
  const int f0 = blockIdx.y * kBN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int mi = lane / 8;  // the ldmatrix matrix this lane names a row of
  // A: pixel lane % 8 + 8 (mi % 2), codes 16 (mi / 2)..; B: output lane % 8 +
  // 8 (mi / 2) of an n8 pair, codes 16 (mi % 2)..
  const int a_lane = (lane % 8 + 8 * (mi % 2)) * kLd + 16 * (mi / 2);
  const int b_lane = (lane % 8 + 8 * (mi / 2)) * kLd + 16 * (mi % 2);
  const int row0 = warp * kRW;

  int acc[kRW][kNT][4];
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0;

  const Tin* const x_img = x + img * s.h_img * s.w_img * s.c;
  for (int c0 = 0; c0 < s.cp; c0 += kKC) {
    if (c0) __syncthreads();  // every warp is done with the last chunk
    // the halo: 4 codes (one 32-bit word) a step, zeros outside the image
    // and past C
    for (int e = threadIdx.x; e < kHaloPix * (kKC / 4); e += kThreads) {
      const int p = e / (kKC / 4);
      const int q = e - p * (kKC / 4);
      const int hh = h0 - 1 + p / kHaloW;
      const int ww = w0 - 1 + p % kHaloW;
      unsigned word = 0;
      if (hh >= 0 && hh < s.h_img && ww >= 0 && ww < s.w_img) {
        const Tin* px = x_img + ((long long)hh * s.w_img + ww) * s.c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = c0 + 4 * q + i;
          if (ch < s.c) word |= (unsigned)(code_of(px[ch], k.s_in) & 0xff) << (8 * i);
        }
      }
      *reinterpret_cast<unsigned*>(halo + p * kLd + 4 * q) = word;
    }
    // the weights: [9][Fp][Cp] int8 in the wrapper's layout, 16 bytes a copy
    for (int e = threadIdx.x; e < 9 * kBN * (kKC / 16); e += kThreads) {
      const int row = e / (kKC / 16);  // tap * kBN + output
      const int q = e - row * (kKC / 16);
      const int tap = row / kBN;
      const int nn = row - tap * kBN;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + ((long long)tap * s.fp + f0 + nn) * s.cp + c0 + 16 * q);
      *reinterpret_cast<uint4*>(slab + row * kLd + 16 * q) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int8_t* a_p = halo + ((row0 + tap / 3) * kHaloW + tap % 3) * kLd + a_lane;
      const int8_t* b_p = slab + tap * kBN * kLd + b_lane;
      unsigned a[kRW][4];
#pragma unroll
      for (int r = 0; r < kRW; ++r) ldsm_x4(a[r], a_p + r * kHaloW * kLd);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        // bq[2h], bq[2h + 1]: b0, b1 of n8 tile 2 jp + h
        unsigned bq[4];
        ldsm_x4(bq, b_p + 16 * jp * kLd);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < kRW; ++r) mma_s8(acc[r][2 * jp + h], a[r], bq[2 * h], bq[2 * h + 1]);
      }
    }
  }

  // epilogue: pixel (row0 + r, g + 8e) of the tile, output f0 + 8j + 2tq + i
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int oh = h0 + row0 + r;
    if (oh >= s.h_img) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ow = w0 + g + 8 * e;
      if (ow >= s.w_img) continue;
      const long long pix = (img * s.h_img + oh) * s.w_img + ow;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int fc = f0 + 8 * j + 2 * tq + i;
          if (fc >= s.f) continue;
          const T tag{};
          float t = round_to(__fmul_rn((float)acc[r][j][2 * e + i], scale[fc]), tag);
          t = round_to(__fadd_rn(t, bias[fc]), tag);
          if constexpr (kA) {
            if (k.act == 1) t = fmaxf(t, 0.f);
            y[pix * s.f + fc] = (int8_t)quantize(t, k.s_mid);
          } else {
            if (k.use_rw) t = round_to(__fmul_rn(t, round_to(k.res_weight, tag)), tag);
            if (res != nullptr) t = round_to(__fadd_rn(to_f32(res[pix * s.f + fc]), t), tag);
            y[pix * s.f + fc] = store_as<T>(t);
          }
        }
    }
  }
}

int refusal(const void* w, int n, int h, int w_img, int c, int f) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || f <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<std::uintptr_t>(w) % 16) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

template <typename Tin, typename Tout, typename T, bool kA>
int launch(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* y, int n, int h, int w_img, int c, int f, S8Scalars k, void* stream) {
  const int refused = refusal(w, n, h, w_img, c, f);
  if (refused) return refused;
  const S8Shape s{n, h, w_img, c, f, (c + kKC - 1) / kKC * kKC, (f + kBN - 1) / kBN * kBN,
                  (h + kTH - 1) / kTH, (w_img + kTW - 1) / kTW};
  const long long tiles = (long long)n * s.h_tiles * s.w_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((f + kBN - 1) / kBN));
  conv3x3_s8_kernel<Tin, Tout, T, kA><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const Tin*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const T*>(res), static_cast<Tout*>(y), s, k);
  return cudaGetLastError();
}

template <typename T>
int conv_a(const void* x, const void* w, const void* scale, const void* bias, void* y, int n,
           int h, int w_img, int c, int f, float s_in, float s_mid, int act, void* stream) {
  if (act != 0 && act != 1) return cudaErrorInvalidValue;
  return launch<T, int8_t, T, true>(x, w, scale, bias, nullptr, y, n, h, w_img, c, f,
                                    S8Scalars{s_in, s_mid, 1.f, act, 0}, stream);
}

template <typename T>
int conv_b(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* y, int n, int h, int w_img, int c, int f, float res_weight, int use_rw,
           void* stream) {
  return launch<int8_t, T, T, false>(x, w, scale, bias, res, y, n, h, w_img, c, f,
                                     S8Scalars{1.f, 1.f, res_weight, 0, use_rw}, stream);
}

}  // namespace

// Plain C entry points for ctypes. w: the wrapper's weight, [9][Fp][Cp] int8
// with Fp = F rounded up to 64 and Cp = C rounded up to 32, zero-padded,
// 16-byte aligned; scale: (F,) f32, the host's f32(s) * sa; bias: (F,) f32
// holding the bias rounded to T. The launch goes on `stream` and does not
// synchronise; the return value is cudaGetLastError() right after it (0 =
// launched; cudaErrorInvalidValue / cudaErrorMisalignedAddress with nothing
// launched for an empty shape, an unknown act or a misaligned w).
//
// conv_a: x (n, h, w, c) hin in T, y (n, h, w, f) int8 codes of the
// requantized act(conv + bias); act 0 none, 1 relu.
extern "C" int conv3x3_s8_a_f32(const void* x, const void* w, const void* scale,
                                const void* bias, void* y, int n, int h, int w_img, int c,
                                int f, float s_in, float s_mid, int act, void* stream) {
  return conv_a<float>(x, w, scale, bias, y, n, h, w_img, c, f, s_in, s_mid, act, stream);
}

extern "C" int conv3x3_s8_a_bf16(const void* x, const void* w, const void* scale,
                                 const void* bias, void* y, int n, int h, int w_img, int c,
                                 int f, float s_in, float s_mid, int act, void* stream) {
  return conv_a<__nv_bfloat16>(x, w, scale, bias, y, n, h, w_img, c, f, s_in, s_mid, act,
                               stream);
}

// conv_b: x (n, h, w, c) int8 codes, y (n, h, w, f) in T; res null or (n, h,
// w, f) in T, added last; use_rw: multiply by res_weight (rounded to T) first.
extern "C" int conv3x3_s8_b_f32(const void* x, const void* w, const void* scale,
                                const void* bias, const void* res, void* y, int n, int h,
                                int w_img, int c, int f, float res_weight, int use_rw,
                                void* stream) {
  return conv_b<float>(x, w, scale, bias, res, y, n, h, w_img, c, f, res_weight, use_rw,
                       stream);
}

extern "C" int conv3x3_s8_b_bf16(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* res, void* y, int n, int h,
                                 int w_img, int c, int f, float res_weight, int use_rw,
                                 void* stream) {
  return conv_b<__nv_bfloat16>(x, w, scale, bias, res, y, n, h, w_img, c, f, res_weight,
                               use_rw, stream);
}
