// One conv of the W8A8 int8 conv pair: a SAME 3x3 convolution of int8
// codes, NHWC x the pair's int8 weights, with int32 sums on the tensor cores
// (s8 x s8 -> s32), for Hopper.
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
// even, and act none, relu, relu6 (clip to [0, 6]) or leaky_relu at a slope,
// taken in T as jax.nn.leaky_relu takes it: t >= 0 ? t : T(T(slope) * t). Two entries of one kernel: `conv3x3_s8_a_*` takes hin in T and
// quantizes it in shared memory, and its epilogue ends in the requantize to
// int8; `conv3x3_s8_b_*` takes tq in int8 and its epilogue ends in T, with
// the optional res_weight and residual add. The int32 sums are exact in any
// order (|acc| <= 9 C 127^2), f32(acc) is exact below 2^24 and rounds to
// nearest even above, every later step is one IEEE operation in the order
// above (__fmul_rn and __fadd_rn, which nvcc never contracts into an FMA),
// and each quantize gives the code of the IEEE division (`quantize_pack`), so
// the kernel equals its plain version (ops/conv3x3_s8.py) and JAX's pair bit
// for bit. Build without --use_fast_math.
//
// What bounds it: bytes, at every pair shape. At EDSR's 64->64 on 4 x 192^2
// LR in bf16, conv_a moves 28 MB (0.0085 ms at 3.35 TB/s) and conv_b 33 MB
// (0.0141 ms) for 0.0055 ms of products at the dense int8 rate. The first
// design (one 16 x 16 tile a block, synchronous staging, scalar epilogue)
// spent ~37-59% of a block's cycles in its epilogue, ~25-49% staging and
// ~9-16% in the products (chip_s8_variants.py --first-design). The design,
// layer by layer:
//
// 1. Persistent blocks. The grid is the blocks the card holds at once (SM
//    count x occupancy: one a block, 16 consumer warps); a block walks the
//    output tiles of kTH x kTW = 16 x 16 pixels (576 at 4 x 192^2) in a
//    strided order. The tile was chosen by measurement (chip_s8_variants.py):
//    8 x 16 and 12 x 16 keep fewer warps on an SM, whose products then wait
//    on their own latencies.
// 2. Resident weights. A block copies the conv's codes once into shared
//    memory, in the wrapper's layout [9][Kp/32][Np/8][2][8][16] (tap, k32
//    step, 8 outputs, 16-code half, output, code): every 8 x 16-byte core
//    matrix is 128 contiguous bytes, which `ldmatrix` reads without bank
//    conflicts; the f32 scale and bias beside them. A conv whose codes do not
//    fit beside the rings (C x F past ~15k: 128->128) reads each lane's B
//    words from global memory instead, through L1.
// 3. An asynchronous halo ring. One producer thread keeps the next tiles'
//    (kTH + 2) x (kTW + 2) pixel halos in flight by TMA: a 4-D tiled tensor
//    map over NHWC x, encoded per launch through cudaGetDriverEntryPoint (no
//    -lcuda), whose out-of-bounds zero fill gives the SAME padding and the
//    ragged edge. conv_b's box takes Kp + 16 codes a pixel (zeros past C),
//    so a slot is its code halo at a conflict-free pixel stride; conv_a's
//    takes the C raw values. Each slot has a `full` mbarrier (the producer's
//    arrive.expect_tx and the TMA's bytes) and an `empty` one (its readers).
//    Codes the TMA cannot address (pixels not whole 16-byte granules, or a
//    box past 256 elements: C > 240) are copied by the producer warp into the
//    same ring; conv_a's raw values then, or when no raw slot fits, are read
//    by its consumers straight from x.
// 4. conv_a's quantize, on arrival, by the consumers: each raw halo becomes
//    a code halo (a second ring) with 16-byte reads and 8-byte writes. A code
//    is rint(v * f32(1 / s)), which is the IEEE division's code unless the
//    product lies within kNearHalf of a half-integer; only there is the
//    __fdiv_rn made (a few values in 10^4; a zero never divides).
// 5. Products on the tensor cores, implicit GEMM, mma.sync m16n8k32 s8:
//    consumer warp w owns tile row w (16 pixels) and up to kBN = 64 outputs a
//    pass (F padded to 16, not to 64: LarvaNet's 48 outputs run 48), K = C
//    padded to 32 with zero codes. A (16 pixels x 32 codes) comes by one
//    ldmatrix.x4 from the code halo at the tap's shift (pixel stride Kp + 16
//    bytes, an odd multiple of 16: conflict free), B by ldmatrix from the
//    resident weights. A register-A wgmma m64nNk32 with B by descriptor was
//    built and measured in this pipeline and was no faster (PERF.md).
// 6. Vector epilogues. scale and bias come from shared memory; a warp's
//    values go through its own staging row in shared memory to 16-byte
//    stores: conv_a's requantized codes, conv_b's values in T with its
//    residual read into registers as 16-byte vectors before the products,
//    in flight while they run. The producer is copying later tiles' halos
//    meanwhile.

#include <cuda.h>  // the tensor map's types; the driver call comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <limits>
#include <mutex>

namespace {

constexpr int kTH = 16;                // output rows of a tile
constexpr int kTW = 16;                // output columns of a tile: one m16 operand
constexpr int kRW = 1;                 // tile rows a consumer warp owns
constexpr int kWarps = kTH / kRW;      // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kQV = 8;                 // values a quantize item takes: one 8-byte store of codes
constexpr int kBN = 64;                // outputs of one pass of the products
constexpr int kNPad = 16;              // the wrapper pads F to it (the products' N)
constexpr int kKC = 32;                // codes of a k32 step
constexpr int kHaloW = kTW + 2;
constexpr int kHaloH = kTH + 2;
constexpr int kHaloPix = kHaloH * kHaloW;
constexpr int kRawSlots = 2;           // conv_a's ring of raw T halos, at most
constexpr int kCodeSlots = 3;          // the ring of code halos, at most
constexpr bool kResident = true;       // the weights stay in shared memory where they fit
constexpr int kBoxMax = 256;           // elements of a side of a TMA box
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may ask for
constexpr int kBarBytes = 256;         // the rings' mbarriers, at the base
// y = v * f32(1 / s) lies within 3u |v / s| (u = 2^-24) of f32(v / s): for
// |y| < 128 within 2.3e-5, so rint(y) is rint(f32(v / s)) unless y lies
// nearer than this to a half-integer
constexpr float kNearHalf = 1.f / 16384;

// The launch's shape and shared-memory plan (byte offsets from the 128-byte
// aligned base), made once on the host.
struct S8Shape {
  int n, h_img, w_img, c, f, kp, np, h_tiles, w_tiles;
  long long tiles;
  int raw_stride;   // bytes of a pixel in a raw slot (conv_a: T, whole 16-byte granules)
  int code_stride;  // bytes of a pixel in a code slot: Kc + 16
  int kc;           // codes of a chunk: Kp in the one-halo plan, else a multiple of 32
  int chunks;       // chunks of Kp codes a halo is copied in (1: the one-halo plan)
  int raw_bytes;    // bytes of a raw slot (a multiple of 128)
  int code_bytes;   // bytes of a code slot (a multiple of 128)
  int out_stride;   // bytes of a pixel in a staging row (conv_a: codes; conv_b: T)
  int raw_slots;    // conv_a: slots of the raw ring (0: the consumers read x)
  int code_slots;
  int resident;     // the weights sit in shared memory (else in global memory)
  int off_w, off_scale, off_bias, off_raw, off_code, off_out, smem_bytes;
  int tma;          // the producer copies halos by TMA (else element by element)
  int vec_in;       // x's pixels are whole 16-byte granules at a 16-byte aligned base
  unsigned tx;      // bytes a TMA halo lands
  int vec_out;      // the outputs go out in 16-byte vectors (else element by element)
};

// the epilogue's scalars: conv_a's scales, with r = f32(1 / s) (NaN where s
// or 1 / s is not a normal number: every code then divides); conv_b's
// res_weight
struct S8Scalars {
  float s_in, s_mid, r_in, r_mid, res_weight;
  int act;      // conv_a: 0 none, 1 relu, 2 leaky_relu at `slope`, 3 relu6
  int use_rw;   // conv_b: multiply by res_weight
  float slope;  // conv_a's leaky_relu slope
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// y = v * r (r = f32(1 / s)) leaves rint(f32(v / s)) in doubt: |y| < 128
// and y within kNearHalf of a half-integer, or y NaN (r NaN)
__device__ __forceinline__ bool in_doubt(float y, float q) {
  return !(fabsf(y) >= 128.f) && !(0.5f - fabsf(y - q) > kNearHalf);
}

// rint(f32(v / s)) by the IEEE division, out of line: few values need it
__device__ __noinline__ float rint_quotient(float v, float s) { return rintf(__fdiv_rn(v, s)); }

// The int8 codes clip(rint(f32(v / s)), -127, 127) of N values (rint half
// to even), four to a word (byte i % 4 of packed[i / 4]): rint(v * r) for
// all of them in one straight run, then the division for those in doubt;
// |v * r| >= 128 clips either way, and a zero gives 0 with no division
template <int N>
__device__ __forceinline__ void quantize_pack(const float (&v)[N], unsigned (&packed)[N / 4],
                                              float s, float r) {
  float q[N];
  bool doubt = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    q[i] = rintf(__fmul_rn(v[i], r));
    doubt |= in_doubt(__fmul_rn(v[i], r), q[i]);
  }
  if (doubt) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (in_doubt(__fmul_rn(v[i], r), q[i])) q[i] = rint_quotient(v[i], s);
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) packed[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    packed[i / 4] |= (unsigned)((int)fminf(fmaxf(q[i], -127.f), 127.f) & 0xff) << (8 * (i % 4));
}

// the i-th of the T values packed in 32-bit words
__device__ __forceinline__ float word_value(const unsigned* w, int i, float) {
  return __uint_as_float(w[i]);
}
__device__ __forceinline__ float word_value(const unsigned* w, int i, __nv_bfloat16) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[i / 2] >> (16 * (i % 2)))));
}

// ---- shared memory, barriers and copies ----

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

// the TMA's tile of `map` at (c0, c1, c2, c3), innermost first, into dst
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

// ---- the products ----

// ldmatrix.x4 from shared memory: lane l names row l % 8 of 8 x 8 b16 matrix
// l / 8 and receives, from matrix i, its bytes (l / 4, 4 (l % 4) .. + 3) in
// r[i]: as s8, row g = l / 4 and the four codes 4t .. 4t + 3, t = l % 4
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const int8_t* row) {
#ifdef __CUDA_ARCH__
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
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


// B of outputs 16jp .. 16jp + 15 (two n8 groups) at p, this lane's row
// address or words already added: ldmatrix from the resident weights, or
// from global memory the four words ldmatrix would hand this lane
template <bool kInSmem>
__device__ __forceinline__ void load_b(unsigned (&b)[4], const int8_t* p) {
  if constexpr (kInSmem) {
    ldsm_x4(b, p);
  } else {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    b[0] = q[0];
    b[1] = q[32];
    b[2] = q[64];
    b[3] = q[96];
  }
}

// The products of one pass: acc[r][j] += the warp's r-th row of 16 pixels x
// outputs 8j .. 8j + 7 of the pass's nb, over the 9 taps and the halo's kn
// k32 steps (a chunk of the Kp / 32 = ksteps of the weights). a_p: this
// lane's ldmatrix row of the code halo at tap 0 for the warp's first row;
// w_p: the pass's first 8-output group of tap 0 at the chunk's first step,
// in shared memory (kInSmem) or global memory; w_step: bytes of a (tap,
// step) block of the weights. A B fragment serves the warp's kRW rows.
template <bool kInSmem>
__device__ __forceinline__ void products_mma(int (&acc)[kRW][kBN / 8][4], const int8_t* a_p,
                                             int code_stride, const int8_t* w_p, int w_step,
                                             int ksteps, int kn, int nb, int lane) {
  const int nt = nb / 8;
  // ldmatrix: lanes 0-15 name the rows of group 2jp's two halves, 16-31
  // those of 2jp + 1; a lane's words: row lane / 4, bytes 4 (lane % 4) ..
  const int b_lane = kInSmem ? 16 * lane : 16 * (lane / 4) + 4 * (lane % 4);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int8_t* a_t = a_p + ((tap / 3) * kHaloW + tap % 3) * code_stride;
#pragma unroll 1
    for (int ks = 0; ks < kn; ++ks) {
      unsigned a[kRW][4];
#pragma unroll
      for (int r = 0; r < kRW; ++r) ldsm_x4(a[r], a_t + r * kHaloW * code_stride + kKC * ks);
      const int8_t* b_p = w_p + (tap * ksteps + ks) * w_step + b_lane;
#pragma unroll
      for (int jp = 0; jp < kBN / 16; ++jp) {
        if (2 * jp < nt) {
          unsigned b[4];
          load_b<kInSmem>(b, b_p + 512 * jp);
#pragma unroll
          for (int r = 0; r < kRW; ++r) {
            mma_s8(acc[r][2 * jp], a[r], b[0], b[1]);
            mma_s8(acc[r][2 * jp + 1], a[r], b[2], b[3]);
          }
        }
      }
    }
  }
}

// ---- the halos ----

// Tile `tile`'s origin: tiles run along W, then H, then images.
struct TileAt {
  long long img;
  int h0, w0;
};
__device__ __forceinline__ TileAt tile_at(const S8Shape& s, long long tile) {
  return TileAt{tile / ((long long)s.h_tiles * s.w_tiles),
                (int)(tile / s.w_tiles % s.h_tiles) * kTH, (int)(tile % s.w_tiles) * kTW};
}

// halo pixel p of tile t: its offset in x's image, or -1 outside the image
__device__ __forceinline__ long long halo_pixel(const S8Shape& s, TileAt t, int p) {
  const int hh = t.h0 - 1 + p / kHaloW;
  const int ww = t.w0 - 1 + p % kHaloW;
  if (hh < 0 || hh >= s.h_img || ww < 0 || ww >= s.w_img) return -1;
  return (t.img * s.h_img + hh) * s.w_img + ww;
}

// conv_b's code halo of tile t into a slot by the producer warp's 32 lanes,
// for codes the TMA cannot copy: codes cb .. cb + kw a pixel (the chunk's),
// zero past C and outside the image, 16 at a time (one 16-byte load where x
// allows it)
__device__ __forceinline__ void stage_codes(int8_t* slot, const int8_t* __restrict__ x,
                                            const S8Shape& s, TileAt t, int cb, int kw,
                                            int lane) {
  const int g_n = kw / 16;
  for (int e = lane; e < kHaloPix * g_n; e += 32) {
    const int p = e / g_n;
    const int ch0 = 16 * (e - p * g_n);
    const long long at = halo_pixel(s, t, p);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (at >= 0 && cb + ch0 < s.c) {
      const int8_t* src = x + at * s.c + cb + ch0;
      if (s.vec_in) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        unsigned w[4] = {0, 0, 0, 0};
        for (int i = 0; i < 16 && cb + ch0 + i < s.c; ++i)
          w[i / 4] |= (unsigned)(uint8_t)src[i] << (8 * (i % 4));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(slot + p * s.code_stride + ch0) = v;
  }
}

// The codes of kQV consecutive T values at src (16-byte aligned), the first
// n of them real (the rest code 0), four to a word, the values read 16
// bytes at a time
template <typename T>
__device__ __forceinline__ uint2 quantize_run(const T* src, int n, float s, float r) {
  const T tag{};
  float v[kQV];
  if (n >= kQV) {
    unsigned words[kQV * sizeof(T) / 4];
#pragma unroll
    for (int i = 0; i < (int)(kQV * sizeof(T) / 16); ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[i];
      words[4 * i] = u.x;
      words[4 * i + 1] = u.y;
      words[4 * i + 2] = u.z;
      words[4 * i + 3] = u.w;
    }
#pragma unroll
    for (int i = 0; i < kQV; ++i) v[i] = word_value(words, i, tag);
  } else {
#pragma unroll
    for (int i = 0; i < kQV; ++i) v[i] = i < n ? to_f32(src[i]) : 0.f;
  }
  unsigned packed[kQV / 4];
  quantize_pack(v, packed, s, r);
  return make_uint2(packed[0], packed[1]);
}

// conv_a's quantize of tile t's halo into a code halo (codes past C zero) by
// the consumers, kQV codes an item: from a raw slot (the one-halo plan: all
// Kp codes), or with raw null from x itself, element by element (zeros
// outside the image), the codes cb .. cb + kw of the chunk
template <typename T>
__device__ __forceinline__ void quantize_halo(int8_t* codes, const int8_t* raw,
                                              const T* __restrict__ x, const S8Shape& s,
                                              TileAt t, int cb, int kw, float s_in, float r_in) {
  const int q_n = kw / kQV;
  for (int e = threadIdx.x; e < kHaloPix * q_n; e += kConsumers) {
    const int p = e / q_n;
    const int ch0 = kQV * (e - p * q_n);
    uint2 packed;
    if (raw != nullptr) {
      packed = quantize_run(reinterpret_cast<const T*>(raw + p * s.raw_stride) + ch0, s.c - ch0,
                            s_in, r_in);
    } else {
      const long long at = halo_pixel(s, t, p);
      float v[kQV];
#pragma unroll
      for (int i = 0; i < kQV; ++i)
        v[i] = at >= 0 && cb + ch0 + i < s.c ? to_f32(x[at * s.c + cb + ch0 + i]) : 0.f;
      unsigned w[kQV / 4];
      quantize_pack(v, w, s_in, r_in);
      packed = make_uint2(w[0], w[1]);
    }
    *reinterpret_cast<uint2*>(codes + p * s.code_stride + ch0) = packed;
  }
}

// ---- the epilogue ----

// 16 bytes of staged outputs (conv_b: T, already times res_weight) plus 16
// bytes of the residual, each value T(res + t)
__device__ __forceinline__ uint4 add_residual(uint4 t, uint4 r, float) {
  return make_uint4(__float_as_uint(__fadd_rn(__uint_as_float(r.x), __uint_as_float(t.x))),
                    __float_as_uint(__fadd_rn(__uint_as_float(r.y), __uint_as_float(t.y))),
                    __float_as_uint(__fadd_rn(__uint_as_float(r.z), __uint_as_float(t.z))),
                    __float_as_uint(__fadd_rn(__uint_as_float(r.w), __uint_as_float(t.w))));
}
__device__ __forceinline__ unsigned add_bf16x2(unsigned t, unsigned r) {
  unsigned out = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tv = __bfloat162float(__ushort_as_bfloat16((unsigned short)(t >> (16 * i))));
    const float rv = __bfloat162float(__ushort_as_bfloat16((unsigned short)(r >> (16 * i))));
    out |= (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(rv, tv))) << (16 * i);
  }
  return out;
}
__device__ __forceinline__ uint4 add_residual(uint4 t, uint4 r, __nv_bfloat16) {
  return make_uint4(add_bf16x2(t.x, r.x), add_bf16x2(t.y, r.y), add_bf16x2(t.z, r.z),
                    add_bf16x2(t.w, r.w));
}

// 16-byte granules of a warp's output row a lane stores on conv_b's vector
// path
template <typename T>
constexpr int kRowChunks = kTW * kBN * (int)sizeof(T) / (16 * 32);

// the pixels of tile row `row` inside the image (0 past its last row)
__device__ __forceinline__ int row_pixels(const S8Shape& s, TileAt t, int row) {
  return t.h0 + row >= s.h_img ? 0 : s.w_img - t.w0 < kTW ? s.w_img - t.w0 : kTW;
}

// conv_b's residual granules of this lane's output chunks (vector path), in
// flight while the products run
template <typename T>
__device__ __forceinline__ void load_residual(uint4 (&rv)[kRowChunks<T>],
                                              const T* __restrict__ res, const S8Shape& s,
                                              TileAt t, int row, int lane) {
  const int q_px = s.f * (int)sizeof(T) / 16;
  const int n = row_pixels(s, t, row) * q_px;
  const long long pix0 = (t.img * s.h_img + t.h0 + row) * s.w_img + t.w0;
  const int8_t* const base =
      reinterpret_cast<const int8_t*>(res) + pix0 * s.f * (long long)sizeof(T);
#pragma unroll
  for (int r = 0; r < kRowChunks<T>; ++r) {
    const int c = lane + 32 * r;
    if (c < n) rv[r] = *reinterpret_cast<const uint4*>(base + (long long)c * 16);
  }
}

// The first half of the epilogue of one pass (outputs f0 .. f0 + nb) of a
// warp's 16 pixels into its staging row (stage[pixel][output], out_stride
// bytes a pixel): conv_a, the int8 code of act(T(T(acc * scale) + bias));
// conv_b, T(T(acc * scale) + bias) times res_weight, in T
template <typename T, bool kA>
__device__ __forceinline__ void stage_values(const int (&acc)[kBN / 8][4], int8_t* stage,
                                             const float* sc, const float* bi, const S8Shape& s,
                                             int f0, int nb, const S8Scalars& k, int lane) {
  const T tag{};
  const int g = lane / 4;
  const int tq = lane % 4;
  const int nt = nb / 8;
  // v[4j + 2e + i]: pixel g + 8e, the pass's output 8j + 2tq + i
  float v[kBN / 2];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int fl = 8 * j + 2 * tq;
    const float2 scale = j < nt ? *reinterpret_cast<const float2*>(sc + f0 + fl) : float2{};
    const float2 bias = j < nt ? *reinterpret_cast<const float2*>(bi + f0 + fl) : float2{};
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tv = round_to(__fmul_rn((float)acc[j][2 * e + i], i ? scale.y : scale.x), tag);
        tv = round_to(__fadd_rn(tv, i ? bias.y : bias.x), tag);
        if constexpr (kA) {
          if (k.act == 1) {
            tv = fmaxf(tv, 0.f);
          } else if (k.act == 2) {
            if (!(tv >= 0.f)) tv = round_to(__fmul_rn(round_to(k.slope, tag), tv), tag);
          } else if (k.act == 3) {
            tv = fminf(fmaxf(tv, 0.f), 6.f);
          }
        } else {
          if (k.use_rw) tv = round_to(__fmul_rn(tv, round_to(k.res_weight, tag)), tag);
        }
        v[4 * j + 2 * e + i] = tv;
      }
  }
  if constexpr (kA) {
    // packed[j]: pixel g's two codes in its low half, pixel g + 8's in its high
    unsigned packed[kBN / 8];
    quantize_pack(v, packed, k.s_mid, k.r_mid);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      if (j < nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<unsigned short*>(stage + (g + 8 * e) * s.out_stride + 8 * j + 2 * tq) =
              (unsigned short)(packed[j] >> (16 * e));
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int8_t* at = stage + (g + 8 * e) * s.out_stride + (8 * j + 2 * tq) * (int)sizeof(T);
        const float v0 = v[4 * j + 2 * e], v1 = v[4 * j + 2 * e + 1];
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<unsigned*>(at) =
              (unsigned)__bfloat16_as_ushort(store_as<__nv_bfloat16>(v0)) |
              ((unsigned)__bfloat16_as_ushort(store_as<__nv_bfloat16>(v1)) << 16);
        }
      }
    }
  }
}

// conv_a's second half: the warp's staged codes of one pass out to y, 16
// bytes a store on the vector path
__device__ __forceinline__ void store_codes(const int8_t* stage, int8_t* __restrict__ y,
                                            const S8Shape& s, TileAt t, int row, int f0, int nb,
                                            int lane) {
  const int npx = row_pixels(s, t, row);
  int8_t* const out = y + ((t.img * s.h_img + t.h0 + row) * s.w_img + t.w0) * s.f + f0;
  if (s.vec_out) {
    const int q_px = nb / 16;  // F is a multiple of 16: so is every pass
    for (int c = lane; c < npx * q_px; c += 32) {
      const int px = c / q_px;
      const int q = c - px * q_px;
      *reinterpret_cast<uint4*>(out + (long long)px * s.f + 16 * q) =
          *reinterpret_cast<const uint4*>(stage + px * s.out_stride + 16 * q);
    }
  } else {
    const int fb = s.f - f0 < nb ? s.f - f0 : nb;
    for (int c = lane; c < npx * fb; c += 32) {
      const int px = c / fb;
      const int fo = c - px * fb;
      out[(long long)px * s.f + fo] = stage[px * s.out_stride + fo];
    }
  }
}

// conv_b's second half: the warp's staged row out to y, plus the residual
// (rv on the vector path, prefetched; T(res + t))
template <typename T>
__device__ __forceinline__ void store_row(const int8_t* stage, const T* __restrict__ res,
                                          const uint4 (&rv)[kRowChunks<T>], T* __restrict__ y,
                                          const S8Shape& s, TileAt t, int row, int f0, int nb,
                                          int lane) {
  const T tag{};
  const int npx = row_pixels(s, t, row);
  const long long pix0 = (t.img * s.h_img + t.h0 + row) * s.w_img + t.w0;
  if (s.vec_out) {
    // one pass holds all F outputs: the row's npx x F values are one run
    const int q_px = s.f * (int)sizeof(T) / 16;  // 16-byte granules a pixel
    int8_t* const out = reinterpret_cast<int8_t*>(y) + pix0 * s.f * (long long)sizeof(T);
#pragma unroll
    for (int r = 0; r < kRowChunks<T>; ++r) {
      const int c = lane + 32 * r;
      if (c >= npx * q_px) continue;
      const int px = c / q_px;
      uint4 v = *reinterpret_cast<const uint4*>(stage + px * s.out_stride + 16 * (c - px * q_px));
      if (res != nullptr) v = add_residual(v, rv[r], tag);
      *reinterpret_cast<uint4*>(out + (long long)c * 16) = v;
    }
  } else {
    const int fb = s.f - f0 < nb ? s.f - f0 : nb;
    for (int c = lane; c < npx * fb; c += 32) {
      const int px = c / fb;
      const int fo = c - px * fb;
      T v = reinterpret_cast<const T*>(stage + px * s.out_stride)[fo];
      const long long at = (pix0 + px) * s.f + f0 + fo;
      if (res != nullptr) v = store_as<T>(round_to(__fadd_rn(to_f32(res[at]), to_f32(v)), tag));
      y[at] = v;
    }
  }
}

// The kernel. Warps 0 .. kWarps - 1 consume code halos: conv_a's quantize of
// the raw halo on its arrival, the products and the epilogue. The last warp
// produces: the TMA (its lane 0) of each tile's halo into conv_a's raw ring
// or conv_b's code ring, or conv_b's element copy (its 32 lanes). Slot i %
// slots of a ring holds the block's i-th tile; its `full` barrier completes
// when the slot is written, its `empty` one when every reader is done with
// it. Tin is the input (T for conv_a, int8_t for conv_b); Tout the output
// (int8_t for conv_a, T for conv_b); T the residual stream's dtype.
template <typename Tin, typename Tout, typename T, bool kA>
__global__ void __launch_bounds__(kThreads)
    conv3x3_s8_kernel(const Tin* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      const T* __restrict__ res, Tout* __restrict__ y, S8Shape s, S8Scalars k,
                      const __grid_constant__ CUtensorMap halo_map) {
  extern __shared__ __align__(128) int8_t s8_smem[];
  uint64_t* const full_raw = reinterpret_cast<uint64_t*>(s8_smem);
  uint64_t* const empty_raw = full_raw + kRawSlots;
  uint64_t* const full_code = empty_raw + kRawSlots;
  uint64_t* const empty_code = full_code + kCodeSlots;
  uint64_t* const weights_in = empty_code + kCodeSlots;
  int8_t* const wsm = s8_smem + s.off_w;
  float* const sc = reinterpret_cast<float*>(s8_smem + s.off_scale);
  float* const bi = reinterpret_cast<float*>(s8_smem + s.off_bias);

  // the barriers: a code slot completes on conv_a's consumers' arrivals, or
  // on the producer's (its one arrival and the TMA's bytes, or its 32
  // lanes'); a raw slot on the producer's and the TMA's; `weights_in` when
  // every consumer has copied its share of the weights
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.raw_slots; ++i) {
      mbar_init(full_raw + i, 1);
      mbar_init(empty_raw + i, kWarps);
    }
    for (int i = 0; i < s.code_slots; ++i) {
      mbar_init(full_code + i, kA ? kConsumers : s.tma ? 1 : 32);
      mbar_init(empty_code + i, kWarps);
    }
    mbar_init(weights_in, kConsumers);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kWarps) {
    // the producer. Lanes that copy nothing leave: a lane that only waited
    // could fall two phases behind a barrier and read the wrong parity
    if ((kA && s.raw_slots == 0) || (s.tma && lane != 0)) return;
    const int slots = kA ? s.raw_slots : s.code_slots;
    uint64_t* const full = kA ? full_raw : full_code;
    uint64_t* const empty = kA ? empty_raw : empty_code;
    int8_t* const ring = s8_smem + (kA ? s.off_raw : s.off_code);
    const int slot_bytes = kA ? s.raw_bytes : s.code_bytes;
    // a tile's slot uses: its one halo, or each pass's chunks in turn
    const int uses = s.chunks == 1 ? 1 : s.chunks * ((s.np + kBN - 1) / kBN);
    int i = 0;
    for (long long tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
      const TileAt t = tile_at(s, tile);
      for (int u = 0; u < uses; ++u, ++i) {
        const int slot = i % slots;
        if (i >= slots) mbar_wait(empty + slot, (i / slots - 1) & 1);
        if (s.tma) {
          mbar_arrive_expect_tx(full + slot, s.tx);
          tma_load_4d(ring + slot * slot_bytes, &halo_map, 0, t.w0 - 1, t.h0 - 1, (int)t.img,
                      full + slot);
        } else if constexpr (!kA) {
          const int cb = u % s.chunks * s.kc;
          stage_codes(ring + slot * slot_bytes, x, s, t, cb,
                      s.kp - cb < s.kc ? s.kp - cb : s.kc, lane);
          mbar_arrive(full + slot);
        }
      }
    }
    return;
  }

  // the consumers. The resident weights, scale and bias (zero past F),
  // copied while the producer's first halos are in flight
  if (s.resident)
    for (int e = threadIdx.x; e < 9 * s.kp * s.np / 16; e += kConsumers)
      reinterpret_cast<uint4*>(wsm)[e] = reinterpret_cast<const uint4*>(w)[e];
  for (int e = threadIdx.x; e < s.np; e += kConsumers) {
    sc[e] = e < s.f ? scale[e] : 0.f;
    bi[e] = e < s.f ? bias[e] : 0.f;
  }
  mbar_arrive(weights_in);

  // warp `warp` owns tile rows kRW warp .. + kRW - 1
  const int row0 = kRW * warp;
  const int mi = lane / 8;  // the ldmatrix matrix this lane names a row of
  // A: pixel lane % 8 + 8 (mi % 2) of the warp's first row, codes 16 (mi / 2)..
  const int a_lane = (row0 * kHaloW + lane % 8 + 8 * (mi % 2)) * s.code_stride + 16 * (mi / 2);
  const int w_step = s.np / 8 * 256;  // bytes of a (tap, k32 step) block
  int8_t* const stage = s8_smem + s.off_out + row0 * kTW * s.out_stride;  // the warp's rows
  mbar_wait(weights_in, 0);
  int i = 0;  // slot uses of the code ring
  for (long long tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    const TileAt t = tile_at(s, tile);
    uint4 rv[kRW][kRowChunks<Tout>];
    if constexpr (!kA) {
      if (s.vec_out && res != nullptr)
#pragma unroll
        for (int r = 0; r < kRW; ++r) load_residual<T>(rv[r], res, s, t, row0 + r, lane);
    }
    // slot use i: codes cb .. cb + kw of the tile's halo (conv_a quantizes
    // them into the slot first, once every warp is done with its last use)
    const auto take = [&](int cb, int kw) -> const int8_t* {
      const int slot = i % s.code_slots;
      int8_t* const halo = s8_smem + s.off_code + slot * s.code_bytes;
      if constexpr (kA) {
        if (i >= s.code_slots) mbar_wait(empty_code + slot, (i / s.code_slots - 1) & 1);
        if (s.raw_slots) {
          const int rs = i % s.raw_slots;
          mbar_wait(full_raw + rs, (i / s.raw_slots) & 1);
          quantize_halo<T>(halo, s8_smem + s.off_raw + rs * s.raw_bytes, x, s, t, cb, kw,
                           k.s_in, k.r_in);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_raw + rs);  // this warp is done with the raw slot
        } else {
          quantize_halo<T>(halo, nullptr, x, s, t, cb, kw, k.s_in, k.r_in);
        }
        mbar_arrive(full_code + slot);
      }
      mbar_wait(full_code + slot, (i / s.code_slots) & 1);
      return halo;
    };
    const auto give_back = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_code + i % s.code_slots);  // this warp is done with it
      ++i;
    };
    // the one-halo plan takes the tile's halo once for all passes; a chunked
    // one takes each pass's chunks in turn, its sums kept across them
    const int8_t* halo = s.chunks == 1 ? take(0, s.kp) : nullptr;
    for (int f0 = 0; f0 < s.np; f0 += kBN) {
      const int nb = s.np - f0 < kBN ? s.np - f0 : kBN;
      int acc[kRW][kBN / 8][4];
#pragma unroll
      for (int r = 0; r < kRW; ++r)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] = 0;
      for (int ch = 0; ch < s.chunks; ++ch) {
        const int cb = ch * s.kc;
        const int kw = s.kp - cb < s.kc ? s.kp - cb : s.kc;
        if (s.chunks > 1) halo = take(cb, kw);
        const long long w_off = (long long)(cb / kKC) * w_step + f0 / 8 * 256;
        if (s.resident)
          products_mma<true>(acc, halo + a_lane, s.code_stride, wsm + w_off, w_step,
                             s.kp / kKC, kw / kKC, nb, lane);
        else
          products_mma<false>(acc, halo + a_lane, s.code_stride, w + w_off, w_step,
                              s.kp / kKC, kw / kKC, nb, lane);
        if (s.chunks > 1 || f0 + kBN >= s.np) give_back();
      }
#pragma unroll
      for (int r = 0; r < kRW; ++r)
        stage_values<T, kA>(acc[r], stage + r * kTW * s.out_stride, sc, bi, s, f0, nb, k, lane);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        if constexpr (kA)
          store_codes(stage + r * kTW * s.out_stride, reinterpret_cast<int8_t*>(y), s, t,
                      row0 + r, f0, nb, lane);
        else
          store_row<T>(stage + r * kTW * s.out_stride, res, rv[r], y, s, t, row0 + r, f0, nb,
                       lane);
      }
      __syncwarp();  // the staging rows are free for the next pass
    }
  }
}

int refusal(const void* w, int n, int h, int w_img, int c, int f) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || f <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<std::uintptr_t>(w) % 16) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// f32(1 / s), or NaN where s or 1 / s is not a normal number
float reciprocal(float s) {
  const float r = 1.f / s;
  return std::isnormal(s) && std::isnormal(r) ? r : std::numeric_limits<float>::quiet_NaN();
}

// The offsets of a plan with the weights resident or not and raw and code
// slots of the rings (code slots of s.kc codes a pixel); whether it fits in
// a block's shared memory.
bool lay_out(S8Shape& s, bool a, int resident, int raw, int code) {
  s.code_stride = s.kc + 16;
  s.code_bytes = round_up(kHaloPix * s.code_stride, 128);
  s.resident = resident;
  s.raw_slots = raw;
  s.code_slots = code;
  s.off_w = kBarBytes;
  s.off_scale = s.off_w + (resident ? 9 * s.kp * s.np : 0);
  s.off_bias = s.off_scale + 4 * s.np;
  s.off_raw = round_up(s.off_bias + 4 * s.np, 128);
  s.off_code = s.off_raw + raw * s.raw_bytes;
  s.off_out = s.off_code + code * s.code_bytes;
  s.smem_bytes = s.off_out + kTH * kTW * s.out_stride;
  return s.smem_bytes <= kSmemLimit;
}

// The shape and shared-memory plan of a launch: the most that fits in a
// block's shared memory, the weights resident first, then the most slots of
// each ring (conv_a with no raw slot: its consumers read x). Where not even
// one halo of Kp codes fits (C past 480 for conv_b in f32, ~670 for conv_a),
// the halo comes in chunks of Kc codes, Kc the largest multiple of 32 that
// leaves two code slots (else one): copied by the producer warp (conv_b) or
// read from x by the consumers (conv_a), no TMA. 0, or the error to refuse
// it.
int plan(S8Shape& s, bool a, int tin_size, int tout_size, int stream_size, const void* x,
         const void* y, const void* res) {
  s.kp = round_up(s.c, kKC);
  s.kc = s.kp;
  s.chunks = 1;
  s.np = round_up(s.f, kNPad);
  s.h_tiles = (s.h_img + kTH - 1) / kTH;
  s.w_tiles = (s.w_img + kTW - 1) / kTW;
  s.tiles = (long long)s.n * s.h_tiles * s.w_tiles;
  s.raw_stride = round_up(s.c * tin_size, 16);
  s.code_stride = s.kp + 16;
  s.raw_bytes = a ? round_up(kHaloPix * s.raw_stride, 128) : 0;
  s.out_stride = (s.np < kBN ? s.np : kBN) * (a ? 1 : stream_size) + 16;
  // the TMA's box: conv_a's C values (the raw slot's pixel stride), conv_b's
  // code_stride codes (past C: zeros outside the tensor)
  s.vec_in = (s.c * tin_size) % 16 == 0 && aligned16(x);
  s.tma = s.vec_in && (a ? s.c : s.code_stride) <= kBoxMax;
  s.tx = (unsigned)(kHaloPix * (a ? s.raw_stride : s.code_stride));
  // conv_a: whole granules of codes a pixel; conv_b: one pass holds all F
  // outputs, whole 16-byte granules a pixel
  s.vec_out = a ? s.f % 16 == 0 && aligned16(y)
                : s.np <= kBN && (s.f * tout_size) % 16 == 0 && aligned16(y) &&
                      (res == nullptr || aligned16(res));
  const int raw_max = a && s.tma ? kRawSlots : 0;
  for (int resident = kResident ? 1 : 0; resident >= 0; --resident)
    for (int raw = raw_max; raw >= 0; --raw)
      for (int code = kCodeSlots; code >= 1; --code)
        if (lay_out(s, a, resident, raw, code)) {
          if (a) s.tma = raw > 0;
          return cudaSuccess;
        }
  s.tma = 0;
  for (int resident = kResident ? 1 : 0; resident >= 0; --resident)
    for (int code = 2; code >= 1; --code)
      for (s.kc = s.kp - kKC; s.kc >= kKC; s.kc -= kKC)
        if (lay_out(s, a, resident, 0, code)) {
          s.chunks = (s.kp + s.kc - 1) / s.kc;
          return cudaSuccess;
        }
  return cudaErrorInvalidValue;
}

template <typename Tin>
constexpr CUtensorMapDataType kMapType = sizeof(Tin) == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                         : sizeof(Tin) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of x (n, h, w, c) for the halos: boxes of box0 channels x
// (kTW + 2) x (kTH + 2) pixels, zeros outside. cuTensorMapEncodeTiled is
// reached through the runtime, so the library links without -lcuda.
int halo_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* x,
             const S8Shape& s, int box0) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorInvalidValue;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)s.c, (cuuint64_t)s.w_img, (cuuint64_t)s.h_img,
                              (cuuint64_t)s.n};
  const cuuint64_t strides[3] = {(cuuint64_t)s.c * elem, (cuuint64_t)s.w_img * s.c * elem,
                                 (cuuint64_t)s.h_img * s.w_img * s.c * elem};
  const cuuint32_t box[4] = {(cuuint32_t)box0, kHaloW, kHaloH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(x), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Tin, typename Tout, typename T, bool kA>
int launch(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* y, int n, int h, int w_img, int c, int f, S8Scalars k, void* stream) {
  const int refused = refusal(w, n, h, w_img, c, f);
  if (refused) return refused;
  S8Shape s{};
  s.n = n;
  s.h_img = h;
  s.w_img = w_img;
  s.c = c;
  s.f = f;
  const int planned =
      plan(s, kA, (int)sizeof(Tin), (int)sizeof(Tout), (int)sizeof(T), x, y, res);
  if (planned) return planned;
  CUtensorMap map{};
  if (s.tma) {
    const int mapped = halo_map(&map, kMapType<Tin>, (int)sizeof(Tin), x, s,
                                kA ? s.c : s.code_stride);
    if (mapped) return mapped;
  }
  auto kernel = conv3x3_s8_kernel<Tin, Tout, T, kA>;
  // the grid: the blocks the card holds at once. Asked once per device and
  // shared-memory size and kept (a launch of the same plan on the same card
  // asks the runtime nothing); the shared-memory limit, which
  // cudaFuncSetAttribute sets on the current device only, is raised per
  // device too
  struct Asked {
    int attr_bytes = 0, asked_bytes = -1;
    long long asked_blocks = 0;
  };
  static std::mutex mu;
  static Asked per_device[64];
  int device = 0;
  {
    const cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= 64) return cudaErrorInvalidValue;
  }
  long long resident;
  {
    std::lock_guard<std::mutex> lock(mu);
    Asked& a = per_device[device];
    if (s.smem_bytes > a.attr_bytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
      if (err != cudaSuccess) return err;
      a.attr_bytes = s.smem_bytes;
    }
    if (s.smem_bytes != a.asked_bytes) {
      int sms = 0, per_sm = 0;
      cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                            s.smem_bytes);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidValue;
      a.asked_bytes = s.smem_bytes;
      a.asked_blocks = (long long)sms * per_sm;
    }
    resident = a.asked_blocks;
  }
  const unsigned grid = (unsigned)(s.tiles < resident ? s.tiles : resident);
  kernel<<<grid, kThreads, s.smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const Tin*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const T*>(res), static_cast<Tout*>(y), s, k, map);
  return cudaGetLastError();
}

template <typename T>
int conv_a(const void* x, const void* w, const void* scale, const void* bias, void* y, int n,
           int h, int w_img, int c, int f, float s_in, float s_mid, int act, float slope,
           void* stream) {
  if (act < 0 || act > 3 || (act == 2 && !std::isfinite(slope))) return cudaErrorInvalidValue;
  return launch<T, int8_t, T, true>(
      x, w, scale, bias, nullptr, y, n, h, w_img, c, f,
      S8Scalars{s_in, s_mid, reciprocal(s_in), reciprocal(s_mid), 1.f, act, 0, slope}, stream);
}

template <typename T>
int conv_b(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* y, int n, int h, int w_img, int c, int f, float res_weight, int use_rw,
           void* stream) {
  return launch<int8_t, T, T, false>(x, w, scale, bias, res, y, n, h, w_img, c, f,
                                     S8Scalars{1.f, 1.f, 1.f, 1.f, res_weight, 0, use_rw, 0.f},
                                     stream);
}

}  // namespace

// Plain C entry points for ctypes. w: the wrapper's weight, [9][Kp/32][Np/8]
// [2][8][16] int8 (tap, k32 step, 8-output group, 16-code half, output,
// code) with Np = F rounded up to 16 and Kp = C rounded up to 32,
// zero-padded, 16-byte aligned; scale: (F,) f32, the host's f32(s) * sa;
// bias: (F,) f32 holding the bias rounded to T. The launch goes on `stream`
// and does not synchronise; the return value is cudaGetLastError() right
// after it (0 = launched; cudaErrorInvalidValue / cudaErrorMisalignedAddress
// with nothing launched for an empty shape, an unknown act, a shape whose
// smallest plan exceeds shared memory (a 32-code chunk of the halo and the
// staging rows past 227 KB: F's staging rows alone, far past any model) or
// a misaligned w). Any C is taken: past what one code halo holds, in chunks.
//
// conv_a: x (n, h, w, c) hin in T, y (n, h, w, f) int8 codes of the
// requantized act(conv + bias); act 0 none, 1 relu, 2 leaky_relu at `slope`
// (a finite number; rounded to T here), 3 relu6.
extern "C" int conv3x3_s8_a_f32(const void* x, const void* w, const void* scale,
                                const void* bias, void* y, int n, int h, int w_img, int c,
                                int f, float s_in, float s_mid, int act, float slope,
                                void* stream) {
  return conv_a<float>(x, w, scale, bias, y, n, h, w_img, c, f, s_in, s_mid, act, slope,
                       stream);
}

extern "C" int conv3x3_s8_a_bf16(const void* x, const void* w, const void* scale,
                                 const void* bias, void* y, int n, int h, int w_img, int c,
                                 int f, float s_in, float s_mid, int act, float slope,
                                 void* stream) {
  return conv_a<__nv_bfloat16>(x, w, scale, bias, y, n, h, w_img, c, f, s_in, s_mid, act,
                               slope, stream);
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
