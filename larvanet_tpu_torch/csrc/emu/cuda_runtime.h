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
// `cudaGetLastError` returns it.
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
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }

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
