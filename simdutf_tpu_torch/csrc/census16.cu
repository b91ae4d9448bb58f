// census_utf16: one read of a UTF-16 buffer into the routing bits of
// simdutf_tpu/kernels/census.census16_bits (Pallas kernel _census16_kernel).
//
// Floor: HBM bytes, one streaming read of 2 * `length` bytes. Each thread
// ORs the bits of 8-unit chunks (one 16-byte load) in a grid-stride loop;
// a warp OR-reduce and one atomicOr per warp finish it. The astral pattern
// needs each unit's parity, which comes from the flat position (chunks
// start at multiples of 8): the TPU kernel's bitcast of two unit rows into
// one word row, which made parity a lane constant, has no counterpart
// here. Big-endian units are byte-swapped in registers.
#include "utf16.cuh"

namespace {

constexpr int NONASCII = 1, V2 = 2, V3 = 4, VASTRAL = 8;

__global__ void __launch_bounds__(256)
    census_utf16_kernel(const uint16_t* __restrict__ w, long long length,
                        int be, int* __restrict__ out) {
  const bool vec = su::aligned16(w);
  const long long chunks = (length + 7) / 8;
  unsigned bits = 0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 8;
    int u[8];
    su::load_units8(w, p0, length, vec, be, u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (p0 + j < length) {
        const int x = u[j];
        unsigned v = x >= 0x80 ? NONASCII : 0;
        // uniform 2-byte: every unit in 0x80..0x7FF
        v |= (x >= 0x80 && x <= 0x7FF) ? 0 : V2;
        // uniform 3-byte: every unit >= 0x800 and no surrogate
        v |= (x >= 0x800 && !su::is_sur(x)) ? 0 : V3;
        // astral pairs: high surrogates at even positions, lows at odd
        v |= ((j & 1) == 0 ? su::is_hi(x) : su::is_lo(x)) ? 0 : VASTRAL;
        bits |= v;
      }
    }
  }
  bits = __reduce_or_sync(su::FULL, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(out, (int)bits);
}

}  // namespace

// out: one zeroed int32 on the device. Returns cudaGetLastError().
extern "C" int census_utf16(const uint16_t* w, long long length, int be,
                            int* out, void* stream) {
  census_utf16_kernel<<<su::grid_for((length + 7) / 8), 256, 0,
                        (cudaStream_t)stream>>>(w, length, be, out);
  return (int)cudaGetLastError();
}
