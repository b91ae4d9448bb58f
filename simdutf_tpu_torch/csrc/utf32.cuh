// Shared device code of the UTF-32 kernels: word windows and the range
// algebra of simdutf_tpu/ops/utf32.py (a word is invalid above 0x10FFFF or
// in the surrogate band D800-DFFF; a word >= 2^31, negative as an int32,
// is above 0x10FFFF).
//
// Every kernel works on 8 consecutive words per thread (two 16-byte loads).
// Words are the int32 bits of the little-endian uint32 storage.
#pragma once

#include "utf8.cuh"  // warp and block reductions, BIG, NO_EVENT, codes

namespace su {

__device__ __forceinline__ bool too_large32(int w) {
  return (unsigned)w > 0x10FFFFu;
}
__device__ __forceinline__ bool surrogate32(int w) {
  return (unsigned)w - 0xD800u < 0x800u;
}
__device__ __forceinline__ bool bad32(int w) {
  return too_large32(w) || surrogate32(w);
}

// the code point a word emits as UTF-8: a word above 0x10FFFF emits U+0000
// (ops/utf32._emit_utf8 clamps it so); surrogates pass through
__device__ __forceinline__ int emit_cp32(int w) {
  return too_large32(w) ? 0 : w;
}

// UTF-8 bytes of an emitted code point: 1..4
__device__ __forceinline__ int utf8_width(int cp) {
  return 1 + (cp > 0x7F) + (cp > 0x7FF) + (cp > 0xFFFF);
}

// u[j] = word at p0 + j for j in [0, 8), zero at/after lim. p0 is a
// multiple of 8; ``vec`` says the buffer base is 16-byte aligned, so whole
// chunks take two 16-byte loads.
__device__ __forceinline__ void load_words8(const int* __restrict__ w,
                                            long long p0, long long lim,
                                            bool vec, int u[8]) {
  if (vec && p0 + 8 <= lim) {
    const int4 a = *reinterpret_cast<const int4*>(w + p0);
    const int4 b = *reinterpret_cast<const int4*>(w + p0 + 4);
    u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
    u[4] = b.x; u[5] = b.y; u[6] = b.z; u[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = p0 + j < lim ? w[p0 + j] : 0;
  }
}

__device__ __forceinline__ bool aligned16w(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace su
