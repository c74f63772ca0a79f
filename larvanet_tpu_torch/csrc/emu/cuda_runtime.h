// CPU stand-in for the CUDA built-ins the port's kernels use, so that a
// kernel source compiles with a host C++20 compiler and runs on the CPU
// (ops/emulate.py). A launch runs the grid's blocks one after another; a
// block runs one std::thread per CUDA thread, `__syncthreads` is a
// std::barrier, and dynamic shared memory starts as NaNs so that a read
// before a write shows in the result. Static `__shared__` arrays become
// function-local statics, which the sequential blocks take in turn.
#pragma once

#include <barrier>
#include <cmath>
#include <limits>
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

inline thread_local dim3 threadIdx, blockIdx;
inline thread_local std::barrier<>* emu_block_barrier = nullptr;
inline thread_local float* emu_block_smem = nullptr;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline float* emu_smem() { return emu_block_smem; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// the H100's limit of dynamic shared memory a block may ask for
template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, int smem_bytes, cudaStream_t, A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<float> smem(smem_bytes / 4 + 4, std::numeric_limits<float>::quiet_NaN());
        std::barrier<> barrier(threads);
        std::vector<std::thread> block;
        block.reserve(threads);
        for (int t = 0; t < threads; ++t)
          block.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            emu_block_barrier = &barrier;
            emu_block_smem = smem.data();
            kernel(args...);
          });
        for (auto& th : block) th.join();
      }
}
