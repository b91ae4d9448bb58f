// Shared device code of the UTF-16 kernels: unit windows and the surrogate
// algebra of simdutf_tpu/ops/utf16.first_error (a high surrogate must be
// followed by a low one, a low one preceded by a high one).
//
// Every kernel works on 8 consecutive code units per thread (one 16-byte
// load), plus one unit of look-behind and one of look-ahead where the
// surrogate pairing needs them. Units are read in storage order and
// byte-swapped in registers for big-endian input.
#pragma once

#include "utf8.cuh"  // warp and block reductions, BIG, NO_EVENT

namespace su {

__device__ __forceinline__ int bswap16(int v) {
  return ((v << 8) | (v >> 8)) & 0xFFFF;
}
__device__ __forceinline__ bool is_hi(int u) { return (u & 0xFC00) == 0xD800; }
__device__ __forceinline__ bool is_lo(int u) { return (u & 0xFC00) == 0xDC00; }
__device__ __forceinline__ bool is_sur(int u) { return (u & 0xF800) == 0xD800; }

// UTF-8 bytes of one unit as the butterfly engine and scalar/utf16.h:80-94
// count them: 1, 2 or 3, and 2 for every surrogate, paired or not
__device__ __forceinline__ int utf8_bytes(int u) {
  return 1 + (u >= 0x80) + (u >= 0x800 && !is_sur(u));
}

// a lone surrogate: u with its neighbours prv and nxt (zero outside the
// in-range units, and a zero unit is no surrogate)
__device__ __forceinline__ bool lone(int prv, int u, int nxt) {
  return (is_hi(u) && !is_lo(nxt)) || (is_lo(u) && !is_hi(prv));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// u[j] = native unit at p0 + j for j in [0, 8), zero at/after lim. p0 is a
// multiple of 8; ``vec`` says the buffer base is 16-byte aligned, so whole
// chunks take one 16-byte load.
__device__ __forceinline__ void load_units8(const uint16_t* __restrict__ w,
                                            long long p0, long long lim,
                                            bool vec, bool be, int* u) {
  if (vec && p0 + 8 <= lim) {
    const uint4 m = *reinterpret_cast<const uint4*>(w + p0);
    const uint32_t x[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u[2 * k] = x[k] & 0xFFFF;
      u[2 * k + 1] = x[k] >> 16;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = p0 + j < lim ? w[p0 + j] : 0;
  }
  if (be) {
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = bswap16(u[j]);
  }
}

// u[i] = native unit at p0 - 1 + i for i in [0, 10), zero outside [0, lim):
// the chunk of load_units8 with one unit of look-behind and one of
// look-ahead
__device__ __forceinline__ void load_units10(const uint16_t* __restrict__ w,
                                             long long p0, long long lim,
                                             bool vec, bool be, int u[10]) {
  load_units8(w, p0, lim, vec, be, u + 1);
  const int prv = p0 >= 1 && p0 - 1 < lim ? w[p0 - 1] : 0;
  const int nxt = p0 + 8 < lim ? w[p0 + 8] : 0;
  u[0] = be ? bswap16(prv) : prv;
  u[9] = be ? bswap16(nxt) : nxt;
}

}  // namespace su
