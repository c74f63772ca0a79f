// CPU stand-in for the CUDA built-ins the port's kernels use, so that a
// kernel source compiles with a host C++20 compiler and runs on the CPU
// (ops/emulate.py). A launch runs the grid's blocks one after another; a
// block runs one std::thread per CUDA thread, `__syncthreads` is a
// std::barrier over the block and `__syncwarp` one over the thread's warp
// of 32, and dynamic shared memory starts as NaNs (128-byte aligned) so
// that a read before a write shows in the result. Static `__shared__`
// arrays become function-local statics, which the sequential blocks take
// in turn. A stand-in that finds a fault the card would report (a
// misaligned address) records it with `emu_fault`, and the next
// `cudaGetLastError` returns it. The warp-wide PTX instructions the kernels
// run in inline assembly (ldmatrix, mma.sync in bf16, tf32 and s8) have
// stand-ins here that exchange the lanes' operands through a per-warp
// buffer after a `__syncwarp`, as the instruction does across the
// warp's registers; cvt.rna.tf32.f32 has a bit-exact one.
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local std::barrier<>* emu_block_barrier = nullptr;
inline thread_local std::barrier<>* emu_warp_barrier = nullptr;
inline thread_local float* emu_block_smem = nullptr;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_barrier->arrive_and_wait(); }
inline float* emu_smem() { return emu_block_smem; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };

inline std::atomic<int> emu_error{cudaSuccess};
inline void emu_fault(int code) { emu_error.store(code); }
inline bool emu_aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// the H100's limit of dynamic shared memory a block may ask for
template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return emu_error.exchange(cudaSuccess); }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
// a card of one SM that holds one block, so that a persistent kernel's
// blocks each walk several tiles even at the tests' small shapes
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *value = 1;
  return cudaSuccess;
}
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, std::size_t) {
  *blocks = 1;
  return cudaSuccess;
}

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, int smem_bytes, cudaStream_t, A... args) {
  constexpr int kAlign = 128 / sizeof(float);
  const int warps = (threads + 31) / 32;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<float> smem(smem_bytes / 4 + 4 + kAlign,
                                std::numeric_limits<float>::quiet_NaN());
        float* base = smem.data();
        base += (kAlign - reinterpret_cast<std::uintptr_t>(base) / sizeof(float) % kAlign) %
                kAlign;
        std::barrier<> barrier(threads);
        std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
        for (int wi = 0; wi < warps; ++wi)
          warp_barriers.push_back(
              std::make_unique<std::barrier<>>(wi + 1 < warps ? 32 : threads - 32 * wi));
        std::vector<std::thread> block;
        block.reserve(threads);
        for (int t = 0; t < threads; ++t)
          block.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            gridDim = grid;
            emu_block_barrier = &barrier;
            emu_warp_barrier = warp_barriers[t / 32].get();
            emu_block_smem = base;
            kernel(args...);
          });
        for (auto& th : block) th.join();
      }
}

// ---- warp-wide PTX instructions ----

struct EmuWarpRegs {
  const void* rows[32];
  unsigned a[32][4];
  unsigned b[32][2];
};
inline EmuWarpRegs emu_warp_regs[32][2];  // two per warp of the running block
inline thread_local unsigned emu_turn = 0;

// The exchange buffer of this lane's next warp-wide instruction: the warp's
// two buffers in turns. The lanes of a warp run the same sequence of these
// instructions, so they agree on the turn, and a lane writes a buffer again
// only after every lane has passed the barrier of the instruction after
// the one that read it: one `__syncwarp` an instruction suffices.
inline EmuWarpRegs& emu_exchange() { return emu_warp_regs[threadIdx.x / 32][emu_turn++ % 2]; }

inline float emu_bf16_bits(unsigned short u) {
  const uint32_t w = (uint32_t)u << 16;
  float f;
  static_assert(sizeof f == sizeof w);
  __builtin_memcpy(&f, &w, 4);
  return f;
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16: lane l names row l % 8 of
// matrix l / 8 (16 bytes, 16-byte aligned); lane l receives in r[i] the
// elements (l / 4, 2 (l % 4)) and (l / 4, 2 (l % 4) + 1) of matrix i
inline void emu_ldmatrix_x4(unsigned (&r)[4], const void* row) {
  if (!emu_aligned(row, 16)) emu_fault(cudaErrorMisalignedAddress);
  const int lane = (int)(threadIdx.x % 32);
  EmuWarpRegs& w = emu_exchange();
  w.rows[lane] = row;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    const unsigned short* src =
        static_cast<const unsigned short*>(w.rows[8 * i + lane / 4]) + 2 * (lane % 4);
    r[i] = (unsigned)src[0] | ((unsigned)src[1] << 16);
  }
}

inline float __uint_as_float(unsigned u) {
  float f;
  static_assert(sizeof f == sizeof u);
  __builtin_memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  __builtin_memcpy(&u, &f, 4);
  return u;
}

// cvt.rna.tf32.f32, bit for bit: round the magnitude to 10 explicit mantissa
// bits, ties away from zero (add half of the dropped part's unit to the bit
// pattern, then clear the low 13 bits; a carry moves into the exponent, and
// past the largest finite value to infinity); NaN stays NaN
inline unsigned emu_cvt_rna_tf32(float v) {
  const unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a x b, with the
// PTX ISA's fragment layouts (g = lane / 4, t = lane % 4): a[0] holds A(g,
// t), a[1] A(g + 8, t), a[2] A(g, t + 4), a[3] A(g + 8, t + 4); b0 holds B(t;
// g), b1 B(t + 4; g); d[2e + i] is D(g + 8e, 2t + i). Each operand is read
// as the card reads a .tf32 register: its low 13 bits ignored (truncated,
// not rounded); the products of two such values are exact in f32.
inline void emu_mma_m16n8k8_tf32(float* d, const unsigned (&a)[4], unsigned b0, unsigned b1) {
  const int lane = (int)(threadIdx.x % 32);
  EmuWarpRegs& w = emu_exchange();
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  __syncwarp();
  auto tf32 = [](unsigned v) { return __uint_as_float(v & 0xffffe000u); };
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 2; ++e)
    for (int i = 0; i < 2; ++i) {
      const int row = g + 8 * e, col = 2 * t + i;
      float sum = 0.f;
      for (int k = 0; k < 8; ++k) {
        const float av = tf32(w.a[(row % 8) * 4 + k % 4][row / 8 + 2 * (k / 4)]);
        const float bv = tf32(w.b[col * 4 + k % 4][k / 4]);
        sum += av * bv;
      }
      d[2 * e + i] += sum;
    }
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d += a x b, with the
// PTX ISA's fragment layouts (g = lane / 4, t = lane % 4): a[i] holds A(g +
// 8 (i % 2), 8 (i / 2) + 2t, + 1); b_i holds B(8i + 2t, + 1; g); d[2e + i] is
// D(g + 8e, 2t + i)
inline void emu_mma_m16n8k16(float* d, const unsigned (&a)[4], unsigned b0, unsigned b1) {
  const int lane = (int)(threadIdx.x % 32);
  EmuWarpRegs& w = emu_exchange();
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  __syncwarp();
  auto half = [](unsigned v, int k) {
    return emu_bf16_bits((unsigned short)(v >> (16 * (k % 2))));
  };
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 2; ++e)
    for (int i = 0; i < 2; ++i) {
      const int row = g + 8 * e, col = 2 * t + i;
      float sum = 0.f;
      for (int k = 0; k < 16; ++k) {
        const float av = half(w.a[(row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)], k);
        const float bv = half(w.b[col * 4 + (k % 8) / 2][k / 8], k);
        sum += av * bv;
      }
      d[2 * e + i] += sum;
    }
}

// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, d += a x b, with the PTX
// ISA's fragment layouts (g = lane / 4, t = lane % 4): each register holds
// four s8 values, byte i the i-th; a[0] holds A(g, 4t + i), a[1] A(g + 8, 4t +
// i), a[2] A(g, 16 + 4t + i), a[3] A(g + 8, 16 + 4t + i); b0 holds B(4t + i;
// g), b1 B(16 + 4t + i; g); d[2e + i] is D(g + 8e, 2t + i). The s32 sums are
// exact, as on the card.
inline void emu_mma_m16n8k32_s8(int* d, const unsigned (&a)[4], unsigned b0, unsigned b1) {
  const int lane = (int)(threadIdx.x % 32);
  EmuWarpRegs& w = emu_exchange();
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  __syncwarp();
  auto s8 = [](unsigned v, int k) { return (int)(int8_t)(uint8_t)(v >> (8 * (k % 4))); };
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 2; ++e)
    for (int i = 0; i < 2; ++i) {
      const int row = g + 8 * e, col = 2 * t + i;
      int sum = 0;
      for (int k = 0; k < 32; ++k) {
        const int av = s8(w.a[(row % 8) * 4 + (k % 16) / 4][row / 8 + 2 * (k / 16)], k);
        const int bv = s8(w.b[col * 4 + (k % 16) / 4][k / 16], k);
        sum += av * bv;
      }
      d[2 * e + i] += sum;
    }
}

// the IEEE single-precision intrinsics that nvcc never contracts or
// approximates: on the host one rounded operation each
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
