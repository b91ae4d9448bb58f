// Shared device code of the UTF-8 kernels: byte windows, the UTF-8 error
// lattice of simdutf_tpu/ops/utf8.classify, and block reductions.
//
// Every kernel works on 16 consecutive bytes per thread (one 16-byte load)
// plus a few halo bytes on either side; the error lattice needs three bytes
// of look-ahead (a 4-byte sequence's continuations) and three of look-back
// (whether a continuation byte is covered by a preceding lead).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace su {

// error codes, value-for-value simdutf_tpu.errors.error_code
constexpr int HEADER_BITS = 1;
constexpr int TOO_SHORT = 2;
constexpr int TOO_LONG = 3;
constexpr int OVERLONG = 4;
constexpr int TOO_LARGE = 5;
constexpr int SURROGATE = 6;

// event key = position << 8 | code; "no event" = BIG << 8 with the JAX
// package's BIG = 2^31 - 1, so key >> 8 is already the reported position
constexpr unsigned long long BIG = 2147483647ull;
constexpr unsigned long long NO_EVENT = BIG << 8;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool is_cont(int x) { return (x & 0xC0) == 0x80; }
__device__ __forceinline__ bool is_lead4(int x) { return (x & 0xF8) == 0xF0; }

// declared sequence length of a byte: 1..4 for leads, 0 for continuations
// and for the bytes F8..FF that no sequence starts with
__device__ __forceinline__ int seqlen_of(int x) {
  if (x < 0x80) return 1;
  if ((x & 0xE0) == 0xC0) return 2;
  if ((x & 0xF0) == 0xE0) return 3;
  if ((x & 0xF8) == 0xF0) return 4;
  return 0;
}

__device__ __forceinline__ int cp4_of(int x, int b1, int b2, int b3) {
  return ((x & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) |
         (b3 & 0x3F);
}

// error code of a non-continuation byte x followed by b1..b3 (0 = valid)
__device__ __forceinline__ int lead_error(int x, int b1, int b2, int b3) {
  if (x < 0x80) return 0;
  const bool c1 = is_cont(b1), c2 = is_cont(b2), c3 = is_cont(b3);
  if ((x & 0xE0) == 0xC0) {
    if (!c1) return TOO_SHORT;
    return (((x & 0x1F) << 6) | (b1 & 0x3F)) < 0x80 ? OVERLONG : 0;
  }
  if ((x & 0xF0) == 0xE0) {
    if (!(c1 && c2)) return TOO_SHORT;
    const int cp = ((x & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F);
    if (cp < 0x800) return OVERLONG;
    return (cp >= 0xD800 && cp <= 0xDFFF) ? SURROGATE : 0;
  }
  if ((x & 0xF8) == 0xF0) {
    if (!(c1 && c2 && c3)) return TOO_SHORT;
    const int cp = cp4_of(x, b1, b2, b3);
    if (cp <= 0xFFFF) return OVERLONG;
    return cp > 0x10FFFF ? TOO_LARGE : 0;
  }
  return HEADER_BITS;  // F8..FF
}

// Error event at in-range position p: a bad lead reports its own code at
// the lead; a continuation byte that no lead among the three before it
// covers reports TOO_LONG at itself (the "orphan" form of the lattice's
// unconsumed-continuation and leading-continuation events, which puts
// every event in the tile holding it). bm1..bm3 are the bytes at p-1..p-3,
// zero before the buffer start (a zero byte covers nothing).
__device__ __forceinline__ unsigned long long event_key(
    long long p, int x, int b1, int b2, int b3, int bm1, int bm2, int bm3) {
  if (!is_cont(x)) {
    const int e = lead_error(x, b1, b2, b3);
    return e ? ((unsigned long long)p << 8) | (unsigned)e : NO_EVENT;
  }
  const bool covered =
      seqlen_of(bm1) > 1 || seqlen_of(bm2) > 2 || seqlen_of(bm3) > 3;
  return covered ? NO_EVENT : ((unsigned long long)p << 8) | TOO_LONG;
}

// c[i] = byte at p0 - 4 + i for i in [0, 24), zero outside [0, lim).
// p0 is a multiple of 16; ``vec`` says the buffer base is 16-byte aligned,
// so the interior takes one 16-byte and two 4-byte loads.
__device__ __forceinline__ void load_window24(const uint8_t* __restrict__ b,
                                              long long p0, long long lim,
                                              bool vec, int c[24]) {
  uint32_t w[6];
  if (vec && p0 >= 4 && p0 + 20 <= lim) {
    const uint4 m = *reinterpret_cast<const uint4*>(b + p0);
    w[0] = *reinterpret_cast<const uint32_t*>(b + p0 - 4);
    w[1] = m.x;
    w[2] = m.y;
    w[3] = m.z;
    w[4] = m.w;
    w[5] = *reinterpret_cast<const uint32_t*>(b + p0 + 16);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long q = p0 - 4 + 4 * k + j;
        if (q >= 0 && q < lim) v |= (uint32_t)b[q] << (8 * j);
      }
      w[k] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < 24; ++i) c[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
}

__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, v, d);
    v = o < v ? o : v;
  }
  return v;
}

// Block-wide reductions over NW warps, result in every thread. ``s`` is
// shared scratch of NW entries; the trailing barrier lets callers reuse it.
template <int NW>
__device__ __forceinline__ unsigned long long block_min_u64(
    unsigned long long v, unsigned long long* s) {
  v = warp_min_u64(v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long r = s[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = s[w] < r ? s[w] : r;
  __syncthreads();
  return r;
}

template <int NW>
__device__ __forceinline__ int block_sum(int v, int* s) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) r += s[w];
  __syncthreads();
  return r;
}

// exclusive block scan of v; *total gets the block sum
template <int NW>
__device__ __forceinline__ int block_excl_scan(int v, int* s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s[warp] = inc;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int x = s[w];
    base += w < warp ? x : 0;
    tot += x;
  }
  __syncthreads();
  *total = tot;
  return base + inc - v;
}

// blocks for a grid-stride pass over ``items`` with 256 threads: enough to
// fill 132 SMs several times over, at least one
inline int grid_for(long long items) {
  long long blocks = (items + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace su
