// CPU stand-in for the CUDA built-ins the port's kernels use, so that a
// kernel source compiles with a host C++20 compiler and runs on the CPU
// (ops/emulate.py). A launch runs the grid's blocks one after another; a
// block runs its CUDA threads as fibers (ucontext) on the launching thread:
// each runs until it waits (`__syncthreads`, a barrier over the block;
// `__syncwarp`, one over its warp of 32; an mbarrier phase), and then the
// next fiber that can go on runs, in thread order, and in reverse thread
// order every other round, so that a read that needs a barrier shows in
// either direction. A round in which no fiber can go on is a deadlock of
// the kernel's protocol: the stand-in names what each fiber waits on and
// aborts, rather than hang the caller. Dynamic shared memory starts as
// NaNs (128-byte aligned) so that a read before a write shows in the
// result. Static `__shared__` arrays become function-local statics, which
// the sequential blocks take in turn. A stand-in that finds a fault the
// card would report (a misaligned address) records it with `emu_fault`,
// and the next `cudaGetLastError` returns it. The warp-wide PTX
// instructions the kernels run in inline assembly (ldmatrix, mma.sync in
// bf16, tf32 and s8) and __shfl_sync / __shfl_xor_sync have stand-ins here
// that exchange the lanes' operands through a per-warp buffer after a
// `__syncwarp`, as the instruction does across the warp's registers;
// cvt.rna.tf32.f32 has a bit-exact one. mbarriers have stand-ins whose
// waits suspend the fiber until the phase completes.
#pragma once

#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <functional>
#include <string>
#include <vector>

#include <sys/mman.h>
#include <ucontext.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static
#define __grid_constant__

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
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

// a barrier over `count` fibers: the last arrival of a generation releases
// the others
struct EmuBarrier {
  int count = 0, arrived = 0, generation = 0;
};

// a cp.async copy issued and not yet landed (cuda_pipeline.h)
struct EmuCopy {
  void* dst;
  const void* src;
  std::size_t size, zfill;
};

// save the running context into *from and resume *to
inline void emu_switch(ucontext_t* from, ucontext_t* to) { swapcontext(from, to); }

// a context whose first resumption calls fn() on the `size` bytes at `stack`
inline void emu_make_context(ucontext_t* ctx, char* stack, std::size_t size, void (*fn)()) {
  getcontext(ctx);
  ctx->uc_stack.ss_sp = stack;
  ctx->uc_stack.ss_size = size;
  ctx->uc_link = nullptr;
  makecontext(ctx, fn, 0);
}

// one CUDA thread of the running block
struct EmuFiber {
  ucontext_t ctx;
  unsigned tid = 0;
  unsigned turn = 0;               // its warp-wide instructions so far (emu_exchange)
  const int* wait_on = nullptr;    // suspended until *wait_on != wait_val
  int wait_val = 0;
  const char* waits_for = "";      // what it waits on, for the deadlock report
  bool done = false;
  std::vector<EmuCopy> copies;     // its cp.async copies in flight, in issue order
  std::vector<std::size_t> groups; // the copies' count at each commit
};

inline thread_local EmuFiber* emu_self = nullptr;
inline thread_local ucontext_t* emu_scheduler = nullptr;
inline thread_local EmuBarrier* emu_block_barrier = nullptr;
inline thread_local EmuBarrier* emu_warp_barriers = nullptr;
inline thread_local float* emu_block_smem = nullptr;

// a block's mbarriers (by address)
struct EmuBlockSync {
  struct Mbar {
    int expected, pending, phase;
    long long tx;  // bytes still to land in this phase
  };
  std::mutex m;  // never held across a wait
  std::map<const void*, Mbar> mbar;
};
inline thread_local EmuBlockSync* emu_block_sync = nullptr;

// suspend this fiber until *flag != value
inline void emu_wait_until_changed(const int* flag, int value, const char* what) {
  EmuFiber* f = emu_self;
  f->wait_on = flag;
  f->wait_val = value;
  f->waits_for = what;
  emu_switch(&f->ctx, emu_scheduler);
}

inline void emu_arrive_and_wait(EmuBarrier* b, const char* what) {
  const int generation = b->generation;
  if (++b->arrived == b->count) {
    b->arrived = 0;
    ++b->generation;
    return;
  }
  emu_wait_until_changed(&b->generation, generation, what);
}

inline void __syncthreads() { emu_arrive_and_wait(emu_block_barrier, "__syncthreads"); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_arrive_and_wait(&emu_warp_barriers[threadIdx.x / 32], "__syncwarp");
}
inline float* emu_smem() { return emu_block_smem; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };

inline std::atomic<int> emu_error{cudaSuccess};
inline void emu_fault(int code) { emu_error.store(code); }
enum { cudaErrorIllegalInstruction = 715 };

// a shared-memory address: the byte offset from the block's dynamic base
inline std::size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<std::size_t>(static_cast<const char*>(p) -
                                  reinterpret_cast<const char*>(emu_block_smem));
}

// mbarrier.init / arrive / arrive.expect_tx / try_wait.parity, and the
// complete_tx of a bulk copy: a phase completes when its `expected`
// arrivals have come and the bytes its arrivals announced have landed; a
// wait for the phase of parity p returns once the current phase's parity
// differs from p. An arrival or wait on a barrier never initialised
// records an illegal instruction.
inline void emu_mbar_init(void* bar, int count) {
  std::lock_guard<std::mutex> lock(emu_block_sync->m);
  emu_block_sync->mbar[bar] = EmuBlockSync::Mbar{count, count, 0, 0};
}
// under the block's lock: `arrivals` arrivals, `tx` bytes announced (> 0)
// or landed (< 0)
inline void emu_mbar_update(void* bar, int arrivals, long long tx) {
  EmuBlockSync& b = *emu_block_sync;
  auto it = b.mbar.find(bar);
  if (it == b.mbar.end()) {
    emu_fault(cudaErrorIllegalInstruction);
    return;
  }
  EmuBlockSync::Mbar& m = it->second;
  m.pending -= arrivals;
  m.tx += tx;
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.expected;
  }
}
inline void emu_mbar_arrive(void* bar) {
  std::lock_guard<std::mutex> lock(emu_block_sync->m);
  emu_mbar_update(bar, 1, 0);
}
inline void emu_mbar_arrive_expect_tx(void* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lock(emu_block_sync->m);
  emu_mbar_update(bar, 1, bytes);
}
inline void emu_mbar_wait(void* bar, unsigned parity) {
  auto it = emu_block_sync->mbar.find(bar);
  if (it == emu_block_sync->mbar.end()) {
    emu_fault(cudaErrorIllegalInstruction);
    return;
  }
  // returns once the phase's parity differs from `parity`
  if ((unsigned)it->second.phase == (parity & 1u))
    emu_wait_until_changed(&it->second.phase, (int)(parity & 1u), "an mbarrier phase");
}
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
// a card of EMU_SMS SMs (1 unless the build defines it), each of which
// holds one block, so that a persistent kernel's blocks each walk several
// tiles even at the tests' small shapes
#ifndef EMU_SMS
#define EMU_SMS 1
#endif
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *value = EMU_SMS;
  return cudaSuccess;
}
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, std::size_t) {
  *blocks = 1;
  return cudaSuccess;
}

// land the oldest `count` cp.async copies of fiber f
inline void emu_land_copies(EmuFiber* f, std::size_t count) {
  for (std::size_t i = 0; i < count; ++i) {
    const EmuCopy& c = f->copies[i];
    std::memcpy(c.dst, c.src, c.size - c.zfill);
    std::memset(static_cast<char*>(c.dst) + (c.size - c.zfill), 0, c.zfill);
  }
  f->copies.erase(f->copies.begin(), f->copies.begin() + (std::ptrdiff_t)count);
  std::vector<std::size_t> left;
  for (std::size_t end : f->groups)
    if (end > count) left.push_back(end - count);
  f->groups.swap(left);
}

// the body of the running launch, as each fiber of a block starts it
inline thread_local const std::function<void()>* emu_body = nullptr;

inline void emu_fiber_main() {
  (*emu_body)();
  EmuFiber* f = emu_self;
  emu_land_copies(f, f->copies.size());  // the card lands them all in the end
  f->done = true;
  emu_switch(&f->ctx, emu_scheduler);  // never resumed
  std::abort();
}

// a fiber's stack: 2 MB of address space (pages come as they are touched)
// below a guard page; kept for the launching thread's later launches
constexpr std::size_t kEmuStack = std::size_t(2) << 20, kEmuGuard = 4096;
inline char* emu_stack(int i) {
  static thread_local std::vector<char*> stacks;
  while ((int)stacks.size() <= i) {
    void* p = mmap(nullptr, kEmuStack + kEmuGuard, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
      std::fprintf(stderr, "emu: no memory for a fiber's stack\n");
      std::abort();
    }
    mprotect(p, kEmuGuard, PROT_NONE);
    stacks.push_back(static_cast<char*>(p) + kEmuGuard);
  }
  return stacks[i];
}

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, int smem_bytes, cudaStream_t, A... args) {
  constexpr int kAlign = 128 / sizeof(float);
  const int warps = (threads + 31) / 32;
  std::vector<float> smem(smem_bytes / 4 + 4 + kAlign);
  float* base = smem.data();
  base += (kAlign - reinterpret_cast<std::uintptr_t>(base) / sizeof(float) % kAlign) % kAlign;
  const std::function<void()> body = [&] { kernel(args...); };
  std::vector<EmuFiber> fibers(threads);
  std::vector<EmuBarrier> warp_barriers(warps);
  EmuBarrier block_barrier;
  ucontext_t scheduler;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::fill(smem.begin(), smem.end(), std::numeric_limits<float>::quiet_NaN());
        block_barrier = EmuBarrier{threads};
        for (int wi = 0; wi < warps; ++wi)
          warp_barriers[wi] = EmuBarrier{wi + 1 < warps ? 32 : threads - 32 * wi};
        EmuBlockSync sync;
        blockIdx = dim3(bx, by, bz);
        gridDim = grid;
        blockDim = dim3(threads);
        emu_block_barrier = &block_barrier;
        emu_warp_barriers = warp_barriers.data();
        emu_block_smem = base;
        emu_block_sync = &sync;
        emu_scheduler = &scheduler;
        emu_body = &body;
        for (int t = 0; t < threads; ++t) {
          EmuFiber& f = fibers[t];
          f.tid = t;
          f.turn = 0;
          f.wait_on = nullptr;
          f.done = false;
          f.copies.clear();
          f.groups.clear();
          emu_make_context(&f.ctx, emu_stack(t), kEmuStack, emu_fiber_main);
        }
        int left = threads;
        for (int round = 0; left > 0; ++round) {
          bool ran = false;
          for (int i = 0; i < threads; ++i) {
            EmuFiber& f = fibers[round % 2 ? threads - 1 - i : i];
            if (f.done || (f.wait_on != nullptr && *f.wait_on == f.wait_val)) continue;
            f.wait_on = nullptr;
            threadIdx = dim3(f.tid);
            emu_self = &f;
            emu_switch(&scheduler, &f.ctx);
            ran = true;
            if (f.done) --left;
          }
          if (!ran) {
            std::fprintf(stderr, "emu: block (%u, %u, %u) deadlocked; waiting:", bx, by, bz);
            for (const EmuFiber& f : fibers)
              if (!f.done) std::fprintf(stderr, " thread %u on %s;", f.tid, f.waits_for);
            std::fprintf(stderr, "\n");
            std::abort();
          }
        }
      }
  emu_self = nullptr;
}

// ---- warp-wide PTX instructions ----

struct EmuWarpRegs {
  const void* rows[32];
  unsigned a[32][4];
  unsigned b[32][2];
};
inline EmuWarpRegs emu_warp_regs[32][2];  // two per warp of the running block

// The exchange buffer of this lane's next warp-wide instruction: the warp's
// two buffers in turns. The lanes of a warp run the same sequence of these
// instructions, so they agree on the turn, and a lane writes a buffer again
// only after every lane has passed the barrier of the instruction after
// the one that read it: one `__syncwarp` an instruction suffices.
inline EmuWarpRegs& emu_exchange() {
  return emu_warp_regs[threadIdx.x / 32][emu_self->turn++ % 2];
}

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

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: lane l names row l % 8 of
// matrix l / 8 as above; the matrices arrive transposed: lane l receives in
// r[i] the elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix
// i (row, column), the lower row in the low half
inline void emu_ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  if (!emu_aligned(row, 16)) emu_fault(cudaErrorMisalignedAddress);
  const int lane = (int)(threadIdx.x % 32);
  EmuWarpRegs& w = emu_exchange();
  w.rows[lane] = row;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    const unsigned short* r0 = static_cast<const unsigned short*>(w.rows[8 * i + 2 * (lane % 4)]);
    const unsigned short* r1 =
        static_cast<const unsigned short*>(w.rows[8 * i + 2 * (lane % 4) + 1]);
    r[i] = (unsigned)r0[lane / 4] | ((unsigned)r1[lane / 4] << 16);
  }
}

// __shfl_sync over the whole warp (mask 0xffffffff): every lane receives
// lane `src`'s value
inline int __shfl_sync(unsigned, int v, int src) {
  const int lane = (int)(threadIdx.x % 32);
  EmuWarpRegs& w = emu_exchange();
  w.a[lane][0] = (unsigned)v;
  __syncwarp();
  return (int)w.a[src % 32][0];
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

// __shfl_xor_sync over the lanes of `mask` (the whole warp, or the lanes a
// partial last warp has): every lane receives lane (lane ^ m)'s value
inline float __shfl_xor_sync(unsigned, float v, int m) {
  const int lane = (int)(threadIdx.x % 32);
  EmuWarpRegs& w = emu_exchange();
  w.a[lane][0] = __float_as_uint(v);
  __syncwarp();
  return __uint_as_float(w.a[lane ^ m][0]);
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
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
