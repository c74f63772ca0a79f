// CPU stand-in for the bf16 type and conversions of cuda_bf16.h (see
// cuda_runtime.h in this directory): round to nearest even, NaN kept quiet.
#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short u) { return __nv_bfloat16{u}; }
