// CPU stand-in for the cp.async primitives of <cuda_pipeline.h> (see
// cuda_runtime.h in this directory). A copy is issued into the thread's
// list and lands (`size - zfill` bytes from src, then `zfill` zero bytes,
// as the card leaves the destination) only when the thread waits for its
// group: `__pipeline_commit` closes a group of the thread's copies,
// `__pipeline_wait_prior(n)` lands every group but the newest n, and a
// thread that ends lands what it has left. So a read of the destination
// before the issuing thread's wait (and, by another thread, the barrier
// after it) reads what was there before: NaNs in fresh shared memory. Both
// addresses must be aligned to `size`, or the copy records a misaligned
// address with `emu_fault`.
#pragma once

#include <cstddef>
#include <cstring>

#include <cuda_runtime.h>

inline void __pipeline_memcpy_async(void* dst, const void* src, std::size_t size,
                                    std::size_t zfill = 0) {
  if (!emu_aligned(dst, size) || !emu_aligned(src, size)) {
    emu_fault(cudaErrorMisalignedAddress);
    return;
  }
  emu_self->copies.push_back(EmuCopy{dst, src, size, zfill});
}

inline void __pipeline_commit() { emu_self->groups.push_back(emu_self->copies.size()); }

inline void __pipeline_wait_prior(std::size_t n) {
  EmuFiber* f = emu_self;
  if (f->groups.size() > n) emu_land_copies(f, f->groups[f->groups.size() - 1 - n]);
}
