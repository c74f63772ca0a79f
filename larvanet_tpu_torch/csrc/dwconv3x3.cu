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
// 28 MB in and 28 MB out, 0.017 ms at 3.35 TB/s, for 0.13 G f32 operations
// (0.0045 ms on the CUDA cores). The design streams x through each SM once
// and keeps the loads off the critical path and the instructions few:
//
// - Strips. A block owns TW columns x G channel vectors of VT channels
//   (VT = 4 where C and the pointers allow: 16 bytes in f32, 8 in bf16),
//   all of C where C / VT <= 32 (else a chunk of it); each thread NC
//   neighbouring columns of one vector. TW, a power of two from 8 to 128,
//   is picked from W so that the last tile of a row pads at most an eighth
//   of its columns where any TW can (W = 48, 192 and 510 pad none, none and
//   2 of 512) with G TW / NC <= 256 threads; the forward takes NC = 4 where
//   that leaves a block 128 threads, else 2. A strip is one image's TW
//   columns of one chunk, all H rows; a chunk's strips' rows, in order, are
//   cut into equal runs, one a block: the forward's blocks persistent (as
//   many as the card holds at once), every run at least kMinRows rows.
// - A sliding window. Each thread walks its columns down the run's rows
//   with the 3 x (NC + 2) x VT inputs of its next outputs in registers: a
//   new row costs NC + 2 vectors read from shared memory, 9 NC products
//   and NC stores.
// - A ring of rows. x's rows come into shared memory by cp.async (zeros
//   outside the image; in the forward two 8-byte vectors of a pixel a copy
//   where that makes 16 aligned bytes), kDepth rows ahead of the one in
//   use, in a ring of kDepth + 1 slots: a row's copies overlap the rows
//   before it. One __syncthreads a row; a run that crosses into the next
//   strip takes its two first rows as the window's rims, through the same
//   ring.
//
// The weight gradient is a reduction over N H W pixels to 10 C values. It
// walks the same runs with the same window (NC = 2), the ring's slots
// holding g's row beside x's, and each thread adds its columns' products
// (9 taps) and g into 10 VT f32 registers, in row order. The block then
// adds them once: a butterfly of __shfl_xor over a vector's TW / NC lanes
// (up to 32, of one warp) in a fixed order, each round's 10 VT shuffles
// independent, then across its warps through shared memory in warp order
// (two barriers in all), into a workspace where each output's blocks lie
// side by side; a second kernel adds them, a warp an output in a fixed
// order (a lane every 32nd block, then a butterfly). No float atomics: the
// result is the same bit for bit on every run. Bound at batch 16 x 48^2 x
// 48 in f32: 7.1 MB of x and 7.1 MB of g, 0.0042 ms.
//
// Times on the card, the variants tried and what held the first versions
// back: PERF.md row 7 (chip_dw_ab.py).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 32;  // channel vectors a block
constexpr int kMinRows = 8;     // rows a run at least
constexpr int kTaps = 9;
constexpr int kSums = kTaps + 1;  // the wgrad's 9 taps and the bias

// output columns a thread, side by side (NC + 2 vectors read a row): the
// forward takes 4 where a block still has 128 threads, else 2; the wgrad 2
constexpr int kWgradCols = 2;
// rows in flight ahead of the one in use (the ring holds kDepth + 1): the
// forward's long runs keep more in flight; the wgrad's short ones, whose
// slots also hold g, fewer
template <typename T, bool kGrad>
constexpr int kDepth = kGrad ? (sizeof(T) == 4 ? 2 : 3) : (sizeof(T) == 4 ? 4 : 6);

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

struct DwPlan {
  int n, h, w, c;
  int vt;         // channels a vector (VT)
  int g;          // channel vectors a block
  int chunks;     // C / (g VT)
  int tw;         // tile columns
  int cols;       // output columns a thread (NC)
  int copy;       // channel vectors a copy (CV): 2 where that makes 16 bytes, else 1
  int tiles_w;
  int rows;       // a chunk's output rows: its strips' (n tiles_w) H rows
  int runs;       // blocks a chunk (runs of its rows)
  int ring;       // ring slots (kDepth + 1)
};

// The rows a block takes, as the ring streams them: for each strip its run
// crosses, the input rows y = ya - 1 .. yb (outputs ya .. yb - 1): the two
// first fill the window's rims, each later one completes output row y - 1.
struct Cursor {
  int next, end;  // the next strip's first linear row; the run's end
  int img, x0;    // the strip's image and first column
  int y, ya, yb;
  bool live;
};

// a run that reaches the next strip starts it here: 32-bit divisions, once a strip
__device__ __forceinline__ void begin_strip(Cursor& cur, int r, const DwPlan& p) {
  cur.live = r < cur.end;
  if (!cur.live) return;
  const int strip = r / p.h;
  cur.img = strip / p.tiles_w;
  cur.x0 = (strip % p.tiles_w) * p.tw;
  cur.ya = r % p.h;
  cur.yb = cur.end - r < p.h - cur.ya ? cur.ya + (cur.end - r) : p.h;
  cur.y = cur.ya - 1;
  cur.next = r + (cur.yb - cur.ya);
}

__device__ __forceinline__ void start(Cursor& cur, int run, const DwPlan& p) {
  cur.end = (int)((long long)p.rows * (run + 1) / p.runs);
  begin_strip(cur, (int)((long long)p.rows * run / p.runs), p);
}

__device__ __forceinline__ void advance(Cursor& cur, const DwPlan& p) {
  if (++cur.y > cur.yb) begin_strip(cur, cur.next, p);
}

// VT channels of a pixel from global to shared memory: a cp.async of their
// 4, 8 or 16 bytes (zeros where !inside), or, for 2 bytes, a plain copy
template <typename T, int VT>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, bool inside) {
  using VecT = Vec<T, VT>;
  if constexpr (sizeof(VecT) >= 4) {
    __pipeline_memcpy_async(dst, src, sizeof(VecT), inside ? 0 : sizeof(VecT));
  } else {
    VecT v;
    v.v[0] = inside ? *src : from_f32<T>(0.f);
    *reinterpret_cast<VecT*>(dst) = v;
  }
}

// This thread's part of a row's copy, the same on every row: x's TW + 2
// columns (the tile's and its rims) x G vectors are taken pixel major
// (neighbouring threads read neighbouring vectors), CV vectors of a pixel a
// copy, kCopies<NC> a thread at most; with kGrad, g's TW columns, NC a
// thread. kGrad's slots are vector major ([vector][column]: its lanes of
// one vector read neighbours), the forward's pixel major ([column][vector],
// as in memory).
template <int NC>
constexpr int kCopies = (10 * NC + 7) / 8;  // (TW + 2) G / (G TW / NC) at TW = 8

template <int NC>
struct RowCopy {
  int col[kCopies<NC>];  // x: the column, from the tile's first column - 1, or -1: none
  int ch[kCopies<NC>];   // its first channel in the chunk
  int dst[kCopies<NC>];  // its place in a slot
  int gcol[NC], gch[NC], gdst[NC];  // g's (kGrad)
};

template <int VT, int NC, int CV, bool kGrad>
__device__ __forceinline__ RowCopy<NC> row_copy(const DwPlan& p) {
  static_assert(CV == 1 || !kGrad, "the wgrad's slots are vector major");
  RowCopy<NC> rc;
  const int cols = p.tw + 2, threads = p.g * p.tw / NC, per_px = p.g / CV;
#pragma unroll
  for (int j = 0; j < kCopies<NC>; ++j) {
    const int i = threadIdx.x + j * threads, q = i / per_px, gv = i % per_px * CV;
    rc.col[j] = i < cols * per_px ? q : -1;
    rc.ch[j] = gv * VT;
    rc.dst[j] = (kGrad ? gv * cols + q : q * p.g + gv) * VT;
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int i = threadIdx.x + j * threads, q = i / p.g, gv = i % p.g;
    rc.gcol[j] = q;
    rc.gch[j] = gv * VT;
    rc.gdst[j] = (cols * p.g + gv * p.tw + q) * VT;
  }
  return rc;
}

// copy the cursor's row of the strip into a ring slot; with kGrad also g's
// row y - 1 where the row completes an output
template <typename T, int VT, int NC, int CV, bool kGrad>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const T* __restrict__ g,
                                         T* slot, const DwPlan& p, const Cursor& cur,
                                         const RowCopy<NC>& rc, int cbase) {
  const bool row_in = cur.y >= 0 && cur.y < p.h;
  const T* xrow = x + ((long long)cur.img * p.h + (row_in ? cur.y : 0)) * p.w * p.c + cbase;
#pragma unroll
  for (int j = 0; j < kCopies<NC>; ++j) {
    if (rc.col[j] < 0) break;
    const int col = cur.x0 - 1 + rc.col[j];
    const bool inside = row_in && col >= 0 && col < p.w;
    copy_vec<T, VT * CV>(slot + rc.dst[j], inside ? xrow + (long long)col * p.c + rc.ch[j] : x,
                         inside);
  }
  if (!kGrad || cur.y <= cur.ya) return;
  const T* grow = g + ((long long)cur.img * p.h + cur.y - 1) * p.w * p.c + cbase;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = cur.x0 + rc.gcol[j];
    const bool inside = col < p.w;
    copy_vec<T, VT>(slot + rc.gdst[j], inside ? grow + (long long)col * p.c + rc.gch[j] : g,
                    inside);
  }
}

// shift the window up a row and read the new row's NC + 2 vectors (columns
// col .. col + NC + 1 of the slot's x row)
template <typename T, int VT, int NC, bool kGrad>
__device__ __forceinline__ void slide(float (&win)[3][NC + 2][VT], const T* slot,
                                      const DwPlan& p, int col, int gv) {
  using VecT = Vec<T, VT>;
#pragma unroll
  for (int dx = 0; dx < NC + 2; ++dx)
#pragma unroll
    for (int e = 0; e < VT; ++e) {
      win[0][dx][e] = win[1][dx][e];
      win[1][dx][e] = win[2][dx][e];
    }
#pragma unroll
  for (int dx = 0; dx < NC + 2; ++dx) {
    const int at = kGrad ? gv * (p.tw + 2) + col + dx : (col + dx) * p.g + gv;
    const VecT v = *reinterpret_cast<const VecT*>(slot + at * VT);
#pragma unroll
    for (int e = 0; e < VT; ++e) win[2][dx][e] = to_f32(v.v[e]);
  }
}

template <typename T, int VT, bool kGrad>
__host__ __device__ __forceinline__ int slot_elems(const DwPlan& p) {
  return ((p.tw + 2) + (kGrad ? p.tw : 0)) * p.g * VT;
}

// the wgrad's reduction buffer, in floats from the ring's start: past the
// ring, 16-byte aligned
template <typename T, int VT>
__host__ __device__ __forceinline__ int red_offset(const DwPlan& p) {
  const int ring = (kDepth<T, true> + 1) * slot_elems<T, VT, true>(p) * (int)sizeof(T);
  return (ring + 15) / 16 * 4;
}

// grid (runs x chunks): block b walks run b % runs of chunk b / runs.
// Threads: NC columns from NC (threadIdx.x / g) and channel vector
// (threadIdx.x % g).
template <typename T, int VT, int NC, int CV>
__global__ void __launch_bounds__(kMaxThreads)
    dw_forward_kernel(const T* __restrict__ x, const T* __restrict__ k,
                      const float* __restrict__ bias, T* __restrict__ y, DwPlan p) {
  using VecT = Vec<T, VT>;
  constexpr int D = kDepth<T, false>, S = D + 1;
  extern __shared__ __align__(16) uint4 smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int slot_n = slot_elems<T, VT, false>(p);
  const int chunk = blockIdx.x / p.runs, run = blockIdx.x % p.runs;
  const int col = threadIdx.x / p.g * NC, gv = threadIdx.x % p.g;
  const int c0 = (chunk * p.g + gv) * VT;
  const int cbase = chunk * p.g * VT;
  const RowCopy<NC> rc = row_copy<VT, NC, CV, false>(p);
  Cursor load, use;
  start(load, run, p);
  use = load;
  for (int d = 0; d < D; ++d) {
    if (load.live)
      load_row<T, VT, NC, CV, false>(x, nullptr, ring + d * slot_n, p, load, rc, cbase);
    __pipeline_commit();
    advance(load, p);
  }
  float kt[kTaps][VT], bv[VT];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const VecT kv = *reinterpret_cast<const VecT*>(k + (long long)t * p.c + c0);
#pragma unroll
    for (int e = 0; e < VT; ++e) kt[t][e] = to_f32(kv.v[e]);
  }
#pragma unroll
  for (int e = 0; e < VT; ++e) bv[e] = bias[c0 + e];

  float win[3][NC + 2][VT];
  for (int i = 0; use.live; ++i) {
    __pipeline_wait_prior(D - 1);  // this thread's copies of row i have landed
    __syncthreads();               // everyone's have, and row i - 1 is read
    if (load.live)
      load_row<T, VT, NC, CV, false>(x, nullptr, ring + (i + D) % S * slot_n, p, load, rc,
                                     cbase);
    __pipeline_commit();
    advance(load, p);
    slide<T, VT, NC, false>(win, ring + i % S * slot_n, p, col, gv);
    if (use.y > use.ya) {
      T* yrow = y + ((long long)use.img * p.h + use.y - 1) * p.w * p.c + c0;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int gx = use.x0 + col + cc;
        if (gx >= p.w) break;
        float acc[VT];
#pragma unroll
        for (int e = 0; e < VT; ++e) acc[e] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int e = 0; e < VT; ++e)
              acc[e] = __fadd_rn(acc[e], __fmul_rn(win[dy][cc + dx][e], kt[3 * dy + dx][e]));
        VecT out;
#pragma unroll
        for (int e = 0; e < VT; ++e) out.v[e] = from_f32<T>(__fadd_rn(acc[e], bv[e]));
        *reinterpret_cast<VecT*>(yrow + (long long)gx * p.c) = out;
      }
    }
    advance(use, p);
  }
}

// grid (runs x chunks): block b sums run b % runs of chunk b / runs into
// `part`, (kSums, C, runs) f32. Threads: channel vector
// (threadIdx.x / (tw / NC)) and NC columns from NC (threadIdx.x % (tw /
// NC)), NC = kWgradCols, so that a channel vector's columns are tw / NC
// neighbouring lanes of one warp (up to 32) or whole warps.
template <typename T, int VT>
__global__ void __launch_bounds__(kMaxThreads)
    dw_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                    DwPlan p) {
  constexpr int D = kDepth<T, true>, S = D + 1;
  extern __shared__ __align__(16) uint4 smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int slot_n = slot_elems<T, VT, true>(p);
  const int chunk = blockIdx.x / p.runs, run = blockIdx.x % p.runs;
  constexpr int NC = kWgradCols;
  const int lanes = p.tw / NC;  // a channel vector's threads
  const int gv = threadIdx.x / lanes, col = threadIdx.x % lanes * NC;
  const int cbase = chunk * p.g * VT;
  const RowCopy<NC> rc = row_copy<VT, NC, 1, true>(p);
  Cursor load, use;
  start(load, run, p);
  use = load;
  for (int d = 0; d < D; ++d) {
    if (load.live) load_row<T, VT, NC, 1, true>(x, g, ring + d * slot_n, p, load, rc, cbase);
    __pipeline_commit();
    advance(load, p);
  }
  float acc[kSums][VT];
#pragma unroll
  for (int q = 0; q < kSums; ++q)
#pragma unroll
    for (int e = 0; e < VT; ++e) acc[q][e] = 0.f;

  using VecT = Vec<T, VT>;
  float win[3][NC + 2][VT];
  for (int i = 0; use.live; ++i) {
    __pipeline_wait_prior(D - 1);
    __syncthreads();
    if (load.live)
      load_row<T, VT, NC, 1, true>(x, g, ring + (i + D) % S * slot_n, p, load, rc, cbase);
    __pipeline_commit();
    advance(load, p);
    const T* slot = ring + i % S * slot_n;
    slide<T, VT, NC, true>(win, slot, p, col, gv);
    if (use.y > use.ya) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        if (use.x0 + col + cc >= p.w) break;
        const VecT gvv = *reinterpret_cast<const VecT*>(
            slot + ((p.tw + 2) * p.g + gv * p.tw + col + cc) * VT);
#pragma unroll
        for (int e = 0; e < VT; ++e) {
          const float gf = to_f32(gvv.v[e]);
          acc[kTaps][e] = __fadd_rn(acc[kTaps][e], gf);
#pragma unroll
          for (int t = 0; t < kTaps; ++t)
            acc[t][e] = __fadd_rn(acc[t][e], __fmul_rn(win[t / 3][cc + t % 3][e], gf));
        }
      }
    }
    advance(use, p);
  }

  // the block's sum of each value over its columns: a butterfly over a
  // vector's lanes of one warp (the same sum in each; each round's 10 VT
  // shuffles independent), then its warps in order through shared memory
  const int span = lanes < 32 ? lanes : 32, threads = p.g * lanes;
  const int warp_lanes =
      threads - (int)(threadIdx.x & ~31u) < 32 ? threads - (int)(threadIdx.x & ~31u) : 32;
  const unsigned mask = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;
  for (int o = span / 2; o >= 1; o /= 2)
#pragma unroll
    for (int q = 0; q < kSums; ++q)
#pragma unroll
      for (int e = 0; e < VT; ++e)
        acc[q][e] = __fadd_rn(acc[q][e], __shfl_xor_sync(mask, acc[q][e], o));
  float* red = reinterpret_cast<float*>(smem) + red_offset<T, VT>(p);  // a segment's sums
  const int seg = threadIdx.x / span, segs = lanes / span;
  if (threadIdx.x % span == 0)
#pragma unroll
    for (int q = 0; q < kSums; ++q)
#pragma unroll
      for (int e = 0; e < VT; ++e) red[(seg * kSums + q) * VT + e] = acc[q][e];
  __syncthreads();
  // into part[(q C + c) runs + run]: an output's runs side by side
  for (int i = threadIdx.x; i < p.g * kSums * VT; i += threads) {
    const int v = i / (kSums * VT), qe = i % (kSums * VT);  // vector, then (sum, channel)
    float sum = red[(v * segs) * kSums * VT + qe];
    for (int s = 1; s < segs; ++s) sum = __fadd_rn(sum, red[((v * segs + s) * kSums) * VT + qe]);
    const int c = (chunk * p.g + v) * VT + qe % VT;
    part[((long long)(qe / VT) * p.c + c) * p.runs + run] = sum;
  }
}

// dk (9 C) and db (C): a warp an output adds its runs' sums (side by side
// in `part`), lane l runs l, l + 32, ... in order, then the lanes by a
// butterfly in a fixed order
__global__ void __launch_bounds__(kMaxThreads)
    dw_wgrad_finish_kernel(const float* __restrict__ part, float* __restrict__ dk,
                           float* __restrict__ db, int rows, int c) {
  const int i = blockIdx.x * (kMaxThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (i >= kSums * c) return;  // the whole warp
  float sum = 0.f;
#pragma unroll 4
  for (int b = lane; b < rows; b += 32) sum = __fadd_rn(sum, part[(long long)i * rows + b]);
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  if (lane != 0) return;
  if (i < kTaps * c)
    dk[i] = sum;
  else
    db[i - kTaps * c] = sum;
}

// The widest vector (4 channels down to one) that divides C and to whose
// size every pointer is aligned
template <typename T>
int vector_width(int c, const void* const* ptrs, int nptrs) {
  for (int v = 4; v > 1; v /= 2) {
    if (c % v) continue;
    bool aligned = true;
    for (int i = 0; i < nptrs; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % (v * sizeof(T))) aligned = false;
    if (aligned) return v;
  }
  return 1;
}

// TW for NC columns a thread: the widest power of two up to 128 with G TW /
// NC <= kMaxThreads whose last tile pads at most an eighth of its columns,
// else the one that pads the fewest
int tile_width(int w, int g, int nc) {
  int best = 0;
  long long best_pad = 0, best_cols = 1;
  for (int tw = 128; tw >= 8; tw /= 2) {
    if (g * tw / nc > kMaxThreads && tw > 8) continue;
    const long long cols = (w + tw - 1) / tw * (long long)tw, pad = cols - w;
    if (8 * pad <= cols) return tw;
    if (best == 0 || pad * best_cols < best_pad * cols) best = tw, best_pad = pad, best_cols = cols;
  }
  return best;
}

// G: every vector of C where there are at most kMaxGroups, else the largest
// divisor of them that is; NC and TW: the forward 4 columns a thread where
// its tile keeps 128 threads a block, else 2 (the wgrad always 2)
DwPlan make_plan(int n, int h, int w, int c, int v, bool grad) {
  DwPlan p;
  p.n = n, p.h = h, p.w = w, p.c = c, p.vt = v;
  const int nv = c / v;
  p.g = nv <= kMaxGroups ? nv : kMaxGroups;
  while (nv % p.g) --p.g;
  p.chunks = nv / p.g;
  p.cols = 4;
  p.tw = tile_width(w, p.g, 4);
  if (grad || p.g * p.tw / 4 < 128) p.cols = 2, p.tw = tile_width(w, p.g, 2);
  p.tiles_w = (w + p.tw - 1) / p.tw;
  p.rows = (long long)n * p.tiles_w * h > 0x7fffffff ? 0 : n * p.tiles_w * h;
  p.runs = 1;
  p.copy = 1;
  p.ring = 0;
  return p;
}

// runs of at least kMinRows rows, at most `most` a chunk
void set_runs(DwPlan& p, long long most) {
  long long runs = ((long long)p.rows + kMinRows - 1) / kMinRows;
  if (runs > most) runs = most;
  p.runs = runs < 1 ? 1 : (int)runs;
}

template <typename T, int VT, bool kGrad>
size_t smem_bytes(const DwPlan& p) {
  if (!kGrad) return (size_t)(kDepth<T, false> + 1) * slot_elems<T, VT, false>(p) * sizeof(T);
  const int lanes = p.tw / kWgradCols, span = lanes < 32 ? lanes : 32;
  return sizeof(float) * (red_offset<T, VT>(p) + (size_t)(p.g * lanes / span) * kSums * VT);
}

// What a kernel's launch asks of a card, kept per kernel and device
// (cudaFuncSetAttribute acts on the current device only): the dynamic
// shared memory it may take (raised past 48 KB as a launch needs it) and,
// for the last (threads, smem) asked, the blocks the card holds at once. A
// launch at the same shape reads one atomic word; a new shape takes the lock.
struct KernelLimits {
  std::mutex mu;
  std::size_t allowed = 48 * 1024;
  std::atomic<unsigned long long> last{0};  // threads << 48 | smem << 24 | blocks
};
constexpr int kMaxDevices = 64;

// let `kernel` take `smem` bytes on the current device; with `blocks`,
// also the blocks the card holds at once at (threads, smem)
template <typename K>
int prepare(K kernel, KernelLimits (&limits)[kMaxDevices], int threads, int smem,
            long long* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidValue;
  KernelLimits& lim = limits[device];
  const unsigned long long key =
      (unsigned long long)threads << 48 | (unsigned long long)smem << 24, low = 0xffffff;
  unsigned long long got = lim.last.load(std::memory_order_acquire);
  if ((got & ~low) != key) {
    std::lock_guard<std::mutex> lock(lim.mu);
    if ((std::size_t)smem > lim.allowed) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      lim.allowed = smem;
    }
    int sms = 0, per_sm = 0;
    if (blocks) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1 || (long long)sms * per_sm > (long long)low) return cudaErrorInvalidValue;
    }
    got = key | (unsigned long long)sms * per_sm;
    lim.last.store(got, std::memory_order_release);
  }
  if (blocks) *blocks = (long long)(got & low);
  return cudaSuccess;
}

// Each launch path below fills `planned` instead of launching where it is
// given one (dwconv3x3_plan): the plan reported is the plan launched.
template <typename T, int VT, int NC, int CV>
int forward_v(const void* x, const void* k, const void* bias, void* y, DwPlan p,
              cudaStream_t stream, DwPlan* planned) {
  static KernelLimits limits[kMaxDevices];
  const int threads = p.g * p.tw / NC;
  const size_t smem = smem_bytes<T, VT, false>(p);
  long long resident = 0;
  const int err =
      prepare(dw_forward_kernel<T, VT, NC, CV>, limits, threads, (int)smem, &resident);
  if (err != cudaSuccess) return err;
  set_runs(p, resident / p.chunks);
  p.ring = kDepth<T, false> + 1;
  if (planned) {
    *planned = p;
    return cudaSuccess;
  }
  dw_forward_kernel<T, VT, NC, CV><<<p.runs * p.chunks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const float*>(bias),
      static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <typename T, int VT, int CV>
int forward_nc(const void* x, const void* k, const void* bias, void* y, const DwPlan& p,
               cudaStream_t stream, DwPlan* planned) {
  return p.cols == 4 ? forward_v<T, VT, 4, CV>(x, k, bias, y, p, stream, planned)
                     : forward_v<T, VT, 2, CV>(x, k, bias, y, p, stream, planned);
}

// 16-byte copies of two 8-byte vectors where x, C and G allow
template <typename T, int VT>
int forward_cv(const void* x, const void* k, const void* bias, void* y, const DwPlan& p,
               cudaStream_t stream, DwPlan* planned) {
  if constexpr (VT * sizeof(T) == 8)
    if (p.copy == 2) return forward_nc<T, VT, 2>(x, k, bias, y, p, stream, planned);
  return forward_nc<T, VT, 1>(x, k, bias, y, p, stream, planned);
}

// CV for the forward's x: 2 where two vectors make 16 aligned bytes
template <typename T>
int copy_vectors(const DwPlan& p, int v, const void* x) {
  return v * sizeof(T) == 8 && p.g % 2 == 0 && p.c * sizeof(T) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(x) % 16 == 0
             ? 2
             : 1;
}

template <typename T>
int forward(const void* x, const void* k, const void* bias, void* y, int n, int h, int w,
            int c, void* stream, DwPlan* planned = nullptr) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return cudaErrorInvalidValue;
  const void* ptrs[] = {x, k, y};
  const int v = vector_width<T>(c, ptrs, 3);
  DwPlan p = make_plan(n, h, w, c, v, false);
  if (p.rows == 0) return cudaErrorInvalidValue;
  p.copy = copy_vectors<T>(p, v, x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 4: return forward_cv<T, 4>(x, k, bias, y, p, st, planned);
    case 2: return forward_cv<T, 2>(x, k, bias, y, p, st, planned);
    default: return forward_cv<T, 1>(x, k, bias, y, p, st, planned);
  }
}

template <typename T, int VT>
int wgrad_v(const void* x, const void* g, float* part, float* dk, float* db, DwPlan p,
            int max_blocks, cudaStream_t stream, DwPlan* planned) {
  static KernelLimits limits[kMaxDevices];
  // at most max_blocks / chunks runs a chunk, each of kMinRows rows at least
  set_runs(p, max_blocks / p.chunks);
  p.ring = kDepth<T, true> + 1;
  if (planned) {
    *planned = p;
    return cudaSuccess;
  }
  const size_t smem = smem_bytes<T, VT, true>(p);
  int err = prepare(dw_wgrad_kernel<T, VT>, limits, p.g * p.tw / kWgradCols, (int)smem,
                    nullptr);
  if (err != cudaSuccess) return err;
  dw_wgrad_kernel<T, VT><<<p.runs * p.chunks, p.g * p.tw / kWgradCols, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int finish_blocks = (kSums * p.c + kMaxThreads / 32 - 1) / (kMaxThreads / 32);
  dw_wgrad_finish_kernel<<<finish_blocks, kMaxThreads, 0, stream>>>(part, dk, db, p.runs, p.c);
  return cudaGetLastError();
}

template <typename T>
int wgrad(const void* x, const void* g, void* part, void* dk, void* db, int n, int h, int w,
          int c, int max_blocks, void* stream, DwPlan* planned = nullptr) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || max_blocks <= 0) return cudaErrorInvalidValue;
  const void* ptrs[] = {x, g};
  const int v = vector_width<T>(c, ptrs, 2);
  const DwPlan p = make_plan(n, h, w, c, v, true);
  if (p.rows == 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  float* k = static_cast<float*>(dk);
  float* b = static_cast<float*>(db);
  switch (v) {
    case 4: return wgrad_v<T, 4>(x, g, pt, k, b, p, max_blocks, st, planned);
    case 2: return wgrad_v<T, 2>(x, g, pt, k, b, p, max_blocks, st, planned);
    default: return wgrad_v<T, 1>(x, g, pt, k, b, p, max_blocks, st, planned);
  }
}

}  // namespace

// Plain C entry points for ctypes. Contiguous NHWC x and y (n, h, w, c) and
// the kernel k as (3, 3, 1, c), all in the entry's dtype; bias (c,) f32. The
// launch goes on `stream` and does not synchronise; the return value is
// cudaGetLastError() right after it (0 = launched; cudaErrorInvalidValue
// with nothing launched for an empty shape, or one whose strips' rows pass
// 2^31).
extern "C" int dwconv3x3_f32(const void* x, const void* k, const void* bias, void* y, int n,
                             int h, int w, int c, void* stream) {
  return forward<float>(x, k, bias, y, n, h, w, c, stream);
}

extern "C" int dwconv3x3_bf16(const void* x, const void* k, const void* bias, void* y, int n,
                              int h, int w, int c, void* stream) {
  return forward<__nv_bfloat16>(x, k, bias, y, n, h, w, c, stream);
}

// The plan an entry takes for an (n, h, w, c) call whose pointers are a, b
// and c_ptr (the forward's x, k and y; the weight gradient's x and g) and
// whose elements take `item` bytes (4: f32, 2: bf16): the forward's (grad
// 0) or the weight gradient's (grad 1, at most max_blocks blocks), worked
// out by the entry's own launch path with nothing launched: out = {VT, G,
// chunks, TW, tiles_w, ring slots, NC columns a thread, CV vectors a copy,
// runs a chunk}; for tests and chip_smoke.py to see the tile a shape takes.
extern "C" int dwconv3x3_plan(const void* a, const void* b, const void* c_ptr, int item, int n,
                              int h, int w, int c, int grad, int max_blocks, int* out) {
  if (item != 4 && item != 2) return cudaErrorInvalidValue;
  DwPlan p;
  const int err =
      grad ? (item == 4 ? wgrad<float>(a, b, nullptr, nullptr, nullptr, n, h, w, c, max_blocks,
                                       nullptr, &p)
                        : wgrad<__nv_bfloat16>(a, b, nullptr, nullptr, nullptr, n, h, w, c,
                                               max_blocks, nullptr, &p))
           : (item == 4 ? forward<float>(a, b, nullptr, const_cast<void*>(c_ptr), n, h, w, c,
                                         nullptr, &p)
                        : forward<__nv_bfloat16>(a, b, nullptr, const_cast<void*>(c_ptr), n, h,
                                                 w, c, nullptr, &p));
  if (err != cudaSuccess) return err;
  const int got[] = {p.vt, p.g, p.chunks, p.tw, p.tiles_w, p.ring, p.cols, p.copy, p.runs};
  for (int i = 0; i < 9; ++i) out[i] = got[i];
  return cudaSuccess;
}

// The weight gradient: x and g (n, h, w, c) in the entry's dtype; dk (3, 3, 1,
// c) and db (c,) f32; part a workspace of max_blocks x 10 x c f32 (each
// channel chunk's rows go in runs of equal length, one a block, to at most
// max_blocks / chunks blocks and one at least).
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
