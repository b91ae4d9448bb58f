// census_utf8: one read of a UTF-8 buffer into the routing bits of
// simdutf_tpu/kernels/census.census_bits (Pallas kernel _census_kernel).
//
// Floor: HBM bytes, one streaming read of `length` bytes; this version is
// bound by the per-byte checks instead (PERF.md). Each thread ORs
// the bits of 16-byte chunks (one 16-byte load plus the next byte, for the
// first-continuation range checks) in a grid-stride loop; a warp OR-reduce
// and one atomicOr per warp finish it. Positional classes (p % 2, p % 3,
// p % 4) come from the flat byte position: the TPU kernel's bitcast word
// geometry has no counterpart here.
#include "utf8.cuh"

namespace {

constexpr int NONASCII = 1, V2 = 2, V3 = 4, V4 = 8, HAS2 = 16, HAS4 = 32,
              HASLO = 64;

__global__ void __launch_bounds__(256)
    census_utf8_kernel(const uint8_t* __restrict__ b, long long n,
                       long long length, int* __restrict__ out) {
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long chunks = (length + 15) / 16;
  unsigned bits = 0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 16;
    int c[24];
    // raw bytes up to the buffer end: the next byte after the last
    // in-range one is read as stored, as the JAX census reads it
    su::load_window24(b, p0, n, vec, c);
    int r3 = (int)(p0 % 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int x = c[4 + j], x1 = c[5 + j];
      if (p0 + j < length) {
        unsigned v = x >= 0x80 ? NONASCII : HASLO;
        const bool cont = su::is_cont(x);
        // uniform 2-byte: C2..DF at even positions, continuations at odd
        const bool ok2 = (j & 1) == 0 ? (x >= 0xC2 && x <= 0xDF) : cont;
        // uniform 3-byte: E0..EF leads with in-class first continuation
        // (E0 needs A0..BF, ED needs 80..9F) at positions 0 mod 3
        const bool lead3ok = (x & 0xF0) == 0xE0 && su::is_cont(x1) &&
                             !(x == 0xE0 && x1 < 0xA0) &&
                             !(x == 0xED && x1 >= 0xA0);
        const bool ok3 = r3 == 0 ? lead3ok : cont;
        // uniform 4-byte: F0..F4 leads (F0 needs 90..BF, F4 needs 80..8F)
        const bool lead4ok = x >= 0xF0 && x <= 0xF4 && su::is_cont(x1) &&
                             !(x == 0xF0 && x1 < 0x90) &&
                             !(x == 0xF4 && x1 >= 0x90);
        const bool ok4 = (j & 3) == 0 ? lead4ok : cont;
        v |= ok2 ? 0 : V2;
        v |= ok3 ? 0 : V3;
        v |= ok4 ? 0 : V4;
        v |= (x & 0xE0) == 0xC0 ? HAS2 : 0;
        v |= x >= 0xF0 ? HAS4 : 0;
        bits |= v;
      }
      r3 = r3 == 2 ? 0 : r3 + 1;
    }
  }
  bits = __reduce_or_sync(su::FULL, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(out, (int)bits);
}

}  // namespace

// out: one zeroed int32 on the device. Returns cudaGetLastError().
extern "C" int census_utf8(const uint8_t* b, long long n, long long length,
                           int* out, void* stream) {
  census_utf8_kernel<<<su::grid_for((length + 15) / 16), 256, 0,
                       (cudaStream_t)stream>>>(b, n, length, out);
  return (int)cudaGetLastError();
}
