// Depthwise SAME 3x3 convolution (groups = C), its input gradient and its
// weight and bias gradient, NHWC, for Hopper.
//
// Replaces no TPU kernel: the JAX package computes the depthwise conv of
// `DepthwiseSeparableResBlock` (larvanet_tpu/models/layers.py:199-227,
// dwsr_reduced's blocks) with XLA's `feature_group_count` conv and trains
// through its XLA gradient; no Pallas kernel is involved. In the port the
// convs run on hand-written kernels, so this source carries them:
//
//   forward  y[n, h, w, c] = sum_{dy, dx} x[n, h + dy - 1, w + dx - 1, c] * k[dy, dx, 0, c]
//                            + b[c]
//   dgrad    the same entry with the taps rotated by 180 degrees and a zero bias
//   wgrad    dk[dy, dx, 0, c] = sum_{n, h, w} x[n, h + dy - 1, w + dx - 1, c] * g[n, h, w, c]
//            db[c]            = sum_{n, h, w} g[n, h, w, c]
//
// with zeros outside the image (SAME), k flax's HWIO (3, 3, 1, C) kernel.
// The forward sums the nine f32 products in one fixed order, tap (dy, dx)
// row-major from 0, then adds the bias, each step one IEEE operation
// (__fmul_rn, __fadd_rn: no FMA contraction), so it equals its plain
// version (ops/dwconv3x3.py) bit for bit in f32 and in bf16 (a product of
// two bf16 values is exact in f32; the sum is rounded to bf16 once).
//
// What bounds it: bytes. Nine multiply-adds a value against one read and
// one write: at dwsr_reduced x4's 4 x 192^2 x 48 in f32 the forward moves
// 28 MB in and 28 MB out, 0.017 ms at 3.35 TB/s, for 0.064 GFLOP. The
// design keeps device memory to that: a block of 256 threads owns a tile
// of 8 rows x TW pixels and CB channel vectors (a vector is 16 bytes where
// C and the pointers allow: 4 f32 or 8 bf16 channels; CB the largest power
// of two up to 8 that divides C's vectors, TW = 128 / CB), stages x's
// (8 + 2) x (TW + 2) halo of those channels once in shared memory with
// zeros outside the image, and each thread computes a run of 4 outputs
// along W of one channel vector from it, its 9 taps and bias held in
// registers. A value of x is read from device memory once a tile (its
// one-pixel rims again by the neighbouring tiles, from L2).
//
// The weight gradient is a reduction over N H W pixels to 10 C values.
// Every block owns a run of consecutive tiles (the last run shorter; the
// runs long enough that the blocks of all channel chunks number at most
// the wrapper's WGRAD_BLOCKS) and one channel chunk, stages each tile's x halo and g tile as the forward
// does, and each thread accumulates its run of 4 pixels' 9 products and g
// into 10 registers a channel, in tile order; the block then adds its
// threads' sums by a fixed tree in shared memory and writes them to its
// row of a workspace, and a second kernel adds the rows in block order.
// No float atomics: the result is the same bit for bit on every run.
// Bound at batch 16 x 48^2 x 48 in f32: 7.1 MB of x and 7.1 MB of g,
// 0.0042 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;      // tile rows
constexpr int kRun = 4;     // outputs a thread, along W
constexpr int kMaxCB = 8;   // channel vectors a block
constexpr int kTaps = 9;
constexpr int kSums = kTaps + 1;  // the wgrad's 9 taps and the bias

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

// V channels of one pixel, loaded and stored as one vector
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> zero_vec() {
  Vec<T, V> z;
#pragma unroll
  for (int e = 0; e < V; ++e) z.v[e] = from_f32<T>(0.f);
  return z;
}

struct DwShape {
  int n, h, w, c;
  int cb;       // channel vectors a block (a power of two up to kMaxCB)
  int tw;       // tile columns, kThreads / kTH / cb * kRun
  int tiles_w, tiles_h, tiles;
};

// Stage x's halo of tile `tile` (rows oy - 1 .. oy + kTH, columns ox - 1 ..
// ox + tw) for channel vectors cv0 .. cv0 + cb into halo[hy][hx][cv], zeros
// outside the image; with g non-null, also g's tile into gt[ty][tx][cv]
// (zeros outside the image)
template <typename T, int V>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, const T* __restrict__ g,
                                           Vec<T, V>* halo, Vec<T, V>* gt, const DwShape& s,
                                           int tile, int cv0) {
  using VecT = Vec<T, V>;
  const int cb = s.cb, hw2 = s.tw + 2;
  const int tx = tile % s.tiles_w, rest = tile / s.tiles_w;
  const int oy = (rest % s.tiles_h) * kTH, ox = tx * s.tw, img = rest / s.tiles_h;
  const int count = (kTH + 2) * hw2 * cb;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int cv = i % cb, p = i / cb;
    const int gy = oy + p / hw2 - 1, gx = ox + p % hw2 - 1;
    VecT v = zero_vec<T, V>();
    if (gy >= 0 && gy < s.h && gx >= 0 && gx < s.w)
      v = *reinterpret_cast<const VecT*>(
          x + (((long long)img * s.h + gy) * s.w + gx) * s.c + (long long)(cv0 + cv) * V);
    halo[i] = v;
  }
  if (g == nullptr) return;
  const int gcount = kTH * s.tw * cb;
  for (int i = threadIdx.x; i < gcount; i += kThreads) {
    const int cv = i % cb, p = i / cb;
    const int gy = oy + p / s.tw, gx = ox + p % s.tw;
    VecT v = zero_vec<T, V>();
    if (gy < s.h && gx < s.w)
      v = *reinterpret_cast<const VecT*>(
          g + (((long long)img * s.h + gy) * s.w + gx) * s.c + (long long)(cv0 + cv) * V);
    gt[i] = v;
  }
}

// grid (tiles_w, tiles_h * n, C / V / cb): one tile and channel chunk a block
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dw_forward_kernel(const T* __restrict__ x, const T* __restrict__ k,
                      const float* __restrict__ bias, T* __restrict__ y, DwShape s) {
  using VecT = Vec<T, V>;
  extern __shared__ __align__(16) uint4 smem[];
  VecT* halo = reinterpret_cast<VecT*>(smem);
  const int cb = s.cb, hw2 = s.tw + 2;
  const int cv0 = blockIdx.z * cb;
  const int tile = (blockIdx.y * s.tiles_w) + blockIdx.x;
  stage_tile<T, V>(x, nullptr, halo, nullptr, s, tile, cv0);

  // this thread: channel vector cv, a run of kRun pixels from (ty, tx0)
  const int cv = threadIdx.x % cb, run = threadIdx.x / cb, runs = s.tw / kRun;
  const int ty = run / runs, tx0 = (run % runs) * kRun;
  const int c0 = (cv0 + cv) * V;
  float kt[kTaps][V], bv[V];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const VecT kv = *reinterpret_cast<const VecT*>(k + (long long)t * s.c + c0);
#pragma unroll
    for (int e = 0; e < V; ++e) kt[t][e] = to_f32(kv.v[e]);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) bv[e] = bias[c0 + e];
  __syncthreads();

  const int oy = (blockIdx.y % s.tiles_h) * kTH, img = blockIdx.y / s.tiles_h;
  const int gy = oy + ty;
  if (gy >= s.h) return;
  T* yrow = y + ((long long)img * s.h + gy) * s.w * s.c + c0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int gx = blockIdx.x * s.tw + tx0 + j;
    if (gx >= s.w) break;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const VecT xv = halo[((ty + dy) * hw2 + tx0 + j + dx) * cb + cv];
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(to_f32(xv.v[e]), kt[3 * dy + dx][e]));
      }
    VecT out;
#pragma unroll
    for (int e = 0; e < V; ++e) out.v[e] = from_f32<T>(__fadd_rn(acc[e], bv[e]));
    *reinterpret_cast<VecT*>(yrow + (long long)gx * s.c) = out;
  }
}

// grid (blocks, C / V / cb): block b sums tiles b * per .. min((b + 1) * per,
// tiles) of one channel chunk into row b of `part`, (blocks, kSums, C) f32
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dw_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    float* __restrict__ part, DwShape s, int per) {
  using VecT = Vec<T, V>;
  extern __shared__ __align__(16) uint4 smem[];
  const int cb = s.cb, hw2 = s.tw + 2;
  VecT* halo = reinterpret_cast<VecT*>(smem);
  VecT* gt = halo + (kTH + 2) * hw2 * cb;
  const int cv0 = blockIdx.y * cb;
  const int cv = threadIdx.x % cb, run = threadIdx.x / cb, runs = s.tw / kRun;
  const int ty = run / runs, tx0 = (run % runs) * kRun;
  float acc[kSums][V];
#pragma unroll
  for (int q = 0; q < kSums; ++q)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[q][e] = 0.f;

  const int first = blockIdx.x * per;
  const int last = first + per < s.tiles ? first + per : s.tiles;
  for (int tile = first; tile < last; ++tile) {
    stage_tile<T, V>(x, g, halo, gt, s, tile, cv0);
    __syncthreads();
    // outside the image g is zero: those pixels add nothing
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const VecT gv = gt[(ty * s.tw + tx0 + j) * cb + cv];
      float gf[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        gf[e] = to_f32(gv.v[e]);
        acc[kTaps][e] = __fadd_rn(acc[kTaps][e], gf[e]);
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const VecT xv = halo[((ty + dy) * hw2 + tx0 + j + dx) * cb + cv];
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[3 * dy + dx][e] =
                __fadd_rn(acc[3 * dy + dx][e], __fmul_rn(to_f32(xv.v[e]), gf[e]));
        }
    }
    __syncthreads();
  }

  // the block's sum of each value over its threads of one channel vector
  // (threadIdx.x = run * cb + cv, kThreads / cb runs, a power of two), by a
  // fixed tree in shared memory
  float* red = reinterpret_cast<float*>(smem);
  const int nruns = kThreads / cb;
  const int c0 = (cv0 + cv) * V;
  float* out = part + (long long)blockIdx.x * kSums * s.c;
  for (int q = 0; q < kSums; ++q) {
#pragma unroll
    for (int e = 0; e < V; ++e) red[threadIdx.x * V + e] = acc[q][e];
    __syncthreads();
    for (int stride = nruns / 2; stride >= 1; stride /= 2) {
      if (run < stride)
#pragma unroll
        for (int e = 0; e < V; ++e)
          red[threadIdx.x * V + e] =
              __fadd_rn(red[threadIdx.x * V + e], red[(threadIdx.x + stride * cb) * V + e]);
      __syncthreads();
    }
    if (run == 0)
#pragma unroll
      for (int e = 0; e < V; ++e) out[q * s.c + c0 + e] = red[threadIdx.x * V + e];
    __syncthreads();
  }
}

// dk (9 C) and db (C): the workspace's rows added in block order
__global__ void __launch_bounds__(kThreads)
    dw_wgrad_finish_kernel(const float* __restrict__ part, float* __restrict__ dk,
                           float* __restrict__ db, int blocks, int c) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kSums * c) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum = __fadd_rn(sum, part[(long long)b * kSums * c + i]);
  if (i < kTaps * c)
    dk[i] = sum;
  else
    db[i - kTaps * c] = sum;
}

// The widest vector (16 bytes down to one element) that divides C and to
// whose size every pointer is aligned
template <typename T>
int vector_width(int c, const void* const* ptrs, int nptrs) {
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2) {
    if (c % v) continue;
    bool aligned = true;
    for (int i = 0; i < nptrs; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % (v * sizeof(T))) aligned = false;
    if (aligned) return v;
  }
  return 1;
}

DwShape make_shape(int n, int h, int w, int c, int v) {
  DwShape s;
  s.n = n, s.h = h, s.w = w, s.c = c;
  const int nv = c / v;
  s.cb = kMaxCB;
  while (nv % s.cb) s.cb /= 2;
  s.tw = kThreads / kTH / s.cb * kRun;
  s.tiles_w = (w + s.tw - 1) / s.tw;
  s.tiles_h = (h + kTH - 1) / kTH;
  s.tiles = n * s.tiles_h * s.tiles_w;
  return s;
}

template <typename T>
size_t halo_bytes(const DwShape& s, int v) {
  return (size_t)(kTH + 2) * (s.tw + 2) * s.cb * v * sizeof(T);
}

template <typename T, int V>
int forward_v(const void* x, const void* k, const void* bias, void* y, const DwShape& s,
              cudaStream_t stream) {
  const dim3 grid(s.tiles_w, s.tiles_h * s.n, s.c / V / s.cb);
  dw_forward_kernel<T, V><<<grid, kThreads, halo_bytes<T>(s, V), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const float*>(bias),
      static_cast<T*>(y), s);
  return cudaGetLastError();
}

template <typename T>
int forward(const void* x, const void* k, const void* bias, void* y, int n, int h, int w,
            int c, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return cudaErrorInvalidValue;
  const void* ptrs[] = {x, k, y};
  const int v = vector_width<T>(c, ptrs, 3);
  const DwShape s = make_shape(n, h, w, c, v);
  if (s.tiles_h * (long long)n > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8: return forward_v<T, 8>(x, k, bias, y, s, st);
    case 4: return forward_v<T, 4>(x, k, bias, y, s, st);
    case 2: return forward_v<T, 2>(x, k, bias, y, s, st);
    default: return forward_v<T, 1>(x, k, bias, y, s, st);
  }
}

template <typename T, int V>
int wgrad_v(const void* x, const void* g, float* part, float* dk, float* db, const DwShape& s,
            int max_blocks, cudaStream_t stream) {
  // at most max_blocks blocks in all: each channel chunk's tiles cut into
  // runs of `per`, so a block's fixed reduction is paid once per run
  const int chunks = s.c / V / s.cb;
  const int rows = max_blocks / chunks > 1 ? max_blocks / chunks : 1;
  const int per = (s.tiles + rows - 1) / rows;
  const int blocks = (s.tiles + per - 1) / per;
  const size_t staged = halo_bytes<T>(s, V) + (size_t)kTH * s.tw * s.cb * V * sizeof(T);
  const size_t reduce = (size_t)kThreads * V * sizeof(float);
  const size_t bytes = staged > reduce ? staged : reduce;
  const dim3 grid(blocks, s.c / V / s.cb);
  dw_wgrad_kernel<T, V><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, s, per);
  const int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int finish_blocks = (kSums * s.c + kThreads - 1) / kThreads;
  dw_wgrad_finish_kernel<<<finish_blocks, kThreads, 0, stream>>>(part, dk, db, blocks, s.c);
  return cudaGetLastError();
}

template <typename T>
int wgrad(const void* x, const void* g, void* part, void* dk, void* db, int n, int h, int w,
          int c, int max_blocks, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || max_blocks <= 0) return cudaErrorInvalidValue;
  const void* ptrs[] = {x, g};
  const int v = vector_width<T>(c, ptrs, 2);
  const DwShape s = make_shape(n, h, w, c, v);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* k = static_cast<float*>(dk);
  float* b = static_cast<float*>(db);
  switch (v) {
    case 8: return wgrad_v<T, 8>(x, g, p, k, b, s, max_blocks, st);
    case 4: return wgrad_v<T, 4>(x, g, p, k, b, s, max_blocks, st);
    case 2: return wgrad_v<T, 2>(x, g, p, k, b, s, max_blocks, st);
    default: return wgrad_v<T, 1>(x, g, p, k, b, s, max_blocks, st);
  }
}

}  // namespace

// Plain C entry points for ctypes. Contiguous NHWC x and y (n, h, w, c) and
// the kernel k as (3, 3, 1, c), all in the entry's dtype; bias (c,) f32. The
// launch goes on `stream` and does not synchronise; the return value is
// cudaGetLastError() right after it (0 = launched; cudaErrorInvalidValue
// with nothing launched for an empty shape or more than 65,535 row tiles).
extern "C" int dwconv3x3_f32(const void* x, const void* k, const void* bias, void* y, int n,
                             int h, int w, int c, void* stream) {
  return forward<float>(x, k, bias, y, n, h, w, c, stream);
}

extern "C" int dwconv3x3_bf16(const void* x, const void* k, const void* bias, void* y, int n,
                              int h, int w, int c, void* stream) {
  return forward<__nv_bfloat16>(x, k, bias, y, n, h, w, c, stream);
}

// The weight gradient: x and g (n, h, w, c) in the entry's dtype; dk (3, 3, 1,
// c) and db (c,) f32; part a workspace of max_blocks x 10 x c f32 (at most
// max_blocks blocks in all: each channel chunk's tiles go in runs of equal
// length, the last one shorter, to at most max_blocks / chunks blocks).
extern "C" int dwconv3x3_wgrad_f32(const void* x, const void* g, void* part, void* dk,
                                   void* db, int n, int h, int w, int c, int max_blocks,
                                   void* stream) {
  return wgrad<float>(x, g, part, dk, db, n, h, w, c, max_blocks, stream);
}

extern "C" int dwconv3x3_wgrad_bf16(const void* x, const void* g, void* part, void* dk,
                                    void* db, int n, int h, int w, int c, int max_blocks,
                                    void* stream) {
  return wgrad<__nv_bfloat16>(x, g, part, dk, db, n, h, w, c, max_blocks, stream);
}
