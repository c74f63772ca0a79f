// Adam and AdamW over every trainable parameter in one launch (`--fused_opt
// 1`), for Hopper.
//
// Replaces no TPU kernel: the JAX package's --fused_opt wraps optax's Adam in
// optax.flatten (larvanet_tpu/models/base.py:265-330), so XLA runs the update
// as one fusion over a ravel_pytree vector instead of one per leaf. The port's
// counterpart is this kernel: the moments m and v live in two flat f32
// buffers, each parameter's slice at its offset (ops/adam_flat.py, in JAX's
// ravel_pytree order), and one launch updates p, m and v of every parameter
// whose gradient is given. Per element, in f32, the port's formula (torch's
// Adam / AdamW, optax's update: eps outside the square root, both bias
// corrections, AdamW's decay before the step):
//
//   p <- p * decay                        (AdamW: decay = 1 - lr wd; Adam: 1)
//   m <- m + (1 - b1) (g - m)
//   v <- v b2 + (1 - b2) g g
//   p <- p + neg_step * (m / (sqrt(v) / bc2_sqrt + eps))
//
// with neg_step = -lr / (1 - b1^t) and bc2_sqrt = sqrt(1 - b2^t), scalars of
// the launch. Every operation is written with its IEEE rounding intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): no product is
// contracted into an FMA, so the result does not depend on nvcc's -fmad
// (built with its default, -fmad=true, and without --use_fast_math) and is
// the plain version's sequence of roundings (ops/adam_flat.py).
//
// Layout: a table of the parameters (p, g, offset into m and v, count; g =
// 0: no gradient, the parameter is left as it is, as torch's Adam skips
// it), and a list of chunks, each one block's: (parameter, first element).
// A block of 256 threads walks its chunk of up to kChunk elements in 16-byte
// vectors where p, g, m and v are aligned for them, else one element a
// thread a round.
//
// What bounds it: bytes, 28 a parameter (read p, g, m, v; write p, m, v):
// 1.41 M parameters of the flagship LarvaNet 2x16 move 39.6 MB, 0.012 ms at
// 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements a block at most: 4 vectors of 4 a thread

struct Param {
  float* p;
  const float* g;
  int64_t offset;  // into m and v
  int64_t count;
};

struct Chunk {
  int32_t param;
  int32_t start;  // first element within the parameter
};

struct Scalars {
  float b1c;  // 1 - b1
  float b2;
  float b2c;  // 1 - b2
  float eps;
  float neg_step;
  float bc2_sqrt;
  float decay;
  int adamw;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Scalars& s) {
  if (s.adamw) p = __fmul_rn(p, s.decay);
  m = __fadd_rn(m, __fmul_rn(s.b1c, __fsub_rn(g, m)));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(s.b2c, __fmul_rn(g, g)));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), s.bc2_sqrt), s.eps);
  p = __fadd_rn(p, __fmul_rn(s.neg_step, __fdiv_rn(m, d)));
}

__global__ void __launch_bounds__(kThreads)
adam_flat_kernel(const Param* __restrict__ params, const Chunk* __restrict__ chunks,
                 float* __restrict__ m, float* __restrict__ v, Scalars s) {
  const Chunk c = chunks[blockIdx.x];
  const Param q = params[c.param];
  if (q.g == nullptr) return;
  const int64_t begin = c.start;
  const int64_t end = begin + kChunk < q.count ? begin + kChunk : q.count;
  float* p = q.p;
  const float* g = q.g;
  float* mq = m + q.offset;
  float* vq = v + q.offset;
  const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(mq) | reinterpret_cast<uintptr_t>(vq)) &
                    15) == 0;
  int64_t i = begin;
  if (vec) {
    const int64_t vec_end = begin + ((end - begin) & ~int64_t(3));
    for (int64_t j = begin + 4 * threadIdx.x; j < vec_end; j += 4 * kThreads) {
      float4 pv = *reinterpret_cast<const float4*>(p + j);
      const float4 gv = *reinterpret_cast<const float4*>(g + j);
      float4 mv = *reinterpret_cast<const float4*>(mq + j);
      float4 vv = *reinterpret_cast<const float4*>(vq + j);
      update(pv.x, gv.x, mv.x, vv.x, s);
      update(pv.y, gv.y, mv.y, vv.y, s);
      update(pv.z, gv.z, mv.z, vv.z, s);
      update(pv.w, gv.w, mv.w, vv.w, s);
      *reinterpret_cast<float4*>(p + j) = pv;
      *reinterpret_cast<float4*>(mq + j) = mv;
      *reinterpret_cast<float4*>(vq + j) = vv;
    }
    i = vec_end;
  }
  for (int64_t j = i + threadIdx.x; j < end; j += kThreads) {
    float pj = p[j], mj = mq[j], vj = vq[j];
    update(pj, g[j], mj, vj, s);
    p[j] = pj;
    mq[j] = mj;
    vq[j] = vj;
  }
}

}  // namespace

// The elements one chunk (one block) covers: the wrapper cuts each
// parameter into chunks of this many.
extern "C" int adam_flat_chunk() { return kChunk; }

// One Adam / AdamW step over the parameters of `params` (device memory,
// n_params entries of {float* p, const float* g, int64 offset, int64
// count}), walked by `chunks` (device memory, n_chunks entries of {int32
// param, int32 start}); m and v the flat f32 moments. The scalars come
// rounded to f32 from the caller's doubles, as torch's optimizer hands its
// kernels 1 - b1, 1 - b2, -lr / (1 - b1^t), sqrt(1 - b2^t) and 1 - lr wd.
// Returns a CUDA error code (0: launched).
extern "C" int adam_flat_f32(const void* params, const void* chunks, int n_chunks, void* m,
                             void* v, float b1c, float b2, float b2c, float eps, float neg_step,
                             float bc2_sqrt, float decay, int adamw, void* stream) {
  if (n_chunks < 0) return cudaErrorInvalidValue;
  if (n_chunks == 0) return cudaSuccess;
  Scalars s;
  s.b1c = b1c;
  s.b2 = b2;
  s.b2c = b2c;
  s.eps = eps;
  s.neg_step = neg_step;
  s.bc2_sqrt = bc2_sqrt;
  s.decay = decay;
  s.adamw = adamw;
  adam_flat_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Param*>(params), static_cast<const Chunk*>(chunks),
      static_cast<float*>(m), static_cast<float*>(v), s);
  return static_cast<int>(cudaGetLastError());
}
