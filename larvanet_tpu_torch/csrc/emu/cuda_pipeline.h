// CPU stand-in for the cp.async primitives of <cuda_pipeline.h> (see
// cuda_runtime.h in this directory). A copy is done at once: `size - zfill`
// bytes from src, then `zfill` zero bytes, as the card leaves the
// destination once the copy has landed; commit and wait have nothing left
// to do. Both addresses must be aligned to `size`, or the copy records a
// misaligned address with `emu_fault`.
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
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}

inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(std::size_t) {}
