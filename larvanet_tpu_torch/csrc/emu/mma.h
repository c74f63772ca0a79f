// CPU stand-in for the part of <mma.h> (nvcuda::wmma) the port's kernels use
// (see cuda_runtime.h in this directory): the 16x16x16 shape with bf16 A and
// B and an f32 accumulator. A real fragment is spread over the warp's lanes
// in a layout the program may not rely on; here every lane holds the whole
// 16x16 tile, so loads and products are the warp's in each lane. A and B
// load from row_major memory, B also from col_major. A store
// writes each element from one lane only (element i from lane i % 32), so a
// lane that reads the tile before the warp's `__syncwarp` reads NaNs or
// stale values, as it may on the card. Loads and stores record a misaligned
// address (a pointer not 32-byte aligned, ldm not a multiple of 16 bytes)
// with `emu_fault`, where the card's behaviour would be undefined.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
struct col_major {};
enum layout_t { mem_row_major, mem_col_major };

template <typename Use, int M, int N, int K, typename T, typename Layout = void>
struct fragment {
  static_assert(M == 16 && N == 16 && K == 16, "the stand-in has the 16x16x16 shape only");
  static constexpr int num_elements = M * N;
  float x[M * N];  // the whole tile, row-major
};

inline void emu_check(const void* p, unsigned ldm_bytes) {
  if (!emu_aligned(p, 32) || ldm_bytes % 16) emu_fault(cudaErrorMisalignedAddress);
}

template <typename Use, typename T, typename L, typename V>
inline void fill_fragment(fragment<Use, 16, 16, 16, T, L>& f, const V& v) {
  for (float& e : f.x) e = (float)v;
}

// matrix_a row_major: element (m, k) at p[m * ldm + k]; matrix_b row_major:
// element (k, n) at p[k * ldm + n]. Both are held as x[row * 16 + col].
template <typename Use>
inline void load_matrix_sync(fragment<Use, 16, 16, 16, __nv_bfloat16, row_major>& f,
                             const __nv_bfloat16* p, unsigned ldm) {
  emu_check(p, ldm * 2);
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) f.x[r * 16 + c] = __bfloat162float(p[r * ldm + c]);
}

// matrix_b col_major: element (k, n) at p[n * ldm + k]
inline void load_matrix_sync(fragment<matrix_b, 16, 16, 16, __nv_bfloat16, col_major>& f,
                             const __nv_bfloat16* p, unsigned ldm) {
  emu_check(p, ldm * 2);
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < 16; ++n) f.x[k * 16 + n] = __bfloat162float(p[n * ldm + k]);
}

template <typename LB>
inline void mma_sync(fragment<accumulator, 16, 16, 16, float>& d,
                     const fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major>& a,
                     const fragment<matrix_b, 16, 16, 16, __nv_bfloat16, LB>& b,
                     const fragment<accumulator, 16, 16, 16, float>& c) {
  float out[256];
  for (int i = 0; i < 256; ++i) out[i] = c.x[i];
  for (int m = 0; m < 16; ++m)
    for (int k = 0; k < 16; ++k) {
      const float av = a.x[m * 16 + k];
      for (int n = 0; n < 16; ++n) out[m * 16 + n] += av * b.x[k * 16 + n];
    }
  for (int i = 0; i < 256; ++i) d.x[i] = out[i];
}

inline void store_matrix_sync(float* p, const fragment<accumulator, 16, 16, 16, float>& f,
                              unsigned ldm, layout_t layout) {
  emu_check(p, ldm * 4);
  for (int i = (int)(threadIdx.x % 32); i < 256; i += 32) {
    const int r = i / 16, c = i % 16;
    p[layout == mem_row_major ? r * ldm + c : c * ldm + r] = f.x[i];
  }
}

}  // namespace wmma
}  // namespace nvcuda
