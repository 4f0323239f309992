// Host stand-in for cuda_bf16.h (see cuda_runtime.h here): bfloat16 bits and
// the round-to-nearest-even conversion.
#pragma once
#include <string.h>

struct __nv_bfloat16 { unsigned short bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  unsigned u = static_cast<unsigned>(b.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<unsigned short>((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
