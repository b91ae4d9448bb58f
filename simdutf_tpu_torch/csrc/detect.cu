// detect_encodings: UTF-8, UTF-16LE and UTF-32LE validity of one buffer
// from one read (replaces the Pallas kernel _detect_kernel behind
// simdutf_tpu/kernels/detect_kernel.detect_fused).
//
// Each thread takes 16 bytes per step with the halo of load_window24 (zero
// at/after the length) and runs three machines on them:
//   * UTF-8: the event lattice of utf8.cuh, as the first-event kernel;
//   * UTF-16LE, units k < length / 2: bad when is_high[k] XOR is_low[k+1]
//     (a unit at length / 2 counts as no low), or a low at unit 0; the
//     thread's 8 units and the next one lie inside its window;
//   * UTF-32LE, words k < length / 4: above 0x10FFFF (as uint32, so words
//     >= 2^31 too) or a surrogate.
// Each warp reduces and makes one 64-bit atomicMin on the UTF-8 key
// (pos << 8 | code) and one atomicOr of the two flags. The TPU kernel
// carries these in an output block across a sequential grid and relies on
// the zero tail of its layout; here the length is explicit and bytes past
// it are never read as data.
//
// Floor: HBM bytes, one streaming read of `length` bytes; the UTF-8
// lattice's per-byte work runs only on chunks that hold a byte >= 0x80.
#include "utf16.cuh"

namespace {

__global__ void __launch_bounds__(256)
    detect_kernel(const uint8_t* __restrict__ b, long long length,
                  unsigned long long* __restrict__ key_out,
                  int* __restrict__ flags) {
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long chunks = (length + 15) / 16;
  const long long l16 = length / 2, l32 = length / 4;
  unsigned long long key = su::NO_EVENT;
  int bad = 0;  // bit 0: UTF-16LE invalid, bit 1: UTF-32LE invalid
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 16;
    int c[24];
    su::load_window24(b, p0, length, vec, c);
    // UTF-8; a thread's later chunks lie further on, so its first event stands
    int any_high = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) any_high |= c[4 + j];
    if (any_high >= 0x80 && key == su::NO_EVENT) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (p0 + j < length) {
          const unsigned long long e =
              su::event_key(p0 + j, c[4 + j], c[5 + j], c[6 + j], c[7 + j],
                            c[3 + j], c[2 + j], c[1 + j]);
          key = e < key ? e : key;
        }
      }
    }
    // UTF-16LE: units p0 / 2 + j and the one after each
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long q = p0 / 2 + j;
      if (q < l16) {
        const int u = c[4 + 2 * j] | (c[5 + 2 * j] << 8);
        const int un = q + 1 < l16 ? c[6 + 2 * j] | (c[7 + 2 * j] << 8) : 0;
        if (su::is_hi(u) != su::is_lo(un) || (q == 0 && su::is_lo(u))) bad |= 1;
      }
    }
    // UTF-32LE: words p0 / 4 + j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p0 / 4 + j < l32) {
        const unsigned x = (unsigned)c[4 + 4 * j] | ((unsigned)c[5 + 4 * j] << 8) |
                           ((unsigned)c[6 + 4 * j] << 16) |
                           ((unsigned)c[7 + 4 * j] << 24);
        if (x > 0x10FFFFu || (x >= 0xD800u && x <= 0xDFFFu)) bad |= 2;
      }
    }
  }
  key = su::warp_min_u64(key);
  bad = (int)__reduce_or_sync(su::FULL, (unsigned)bad);
  if ((threadIdx.x & 31) == 0) {
    if (key != su::NO_EVENT) atomicMin(key_out, key);
    if (bad) atomicOr(flags, bad);
  }
}

}  // namespace

// key_out: one int64 on the device set to BIG << 8; flags: one zeroed
// int32. Returns cudaGetLastError().
extern "C" int detect_encodings(const uint8_t* b, long long length,
                                unsigned long long* key_out, int* flags,
                                void* stream) {
  detect_kernel<<<su::grid_for((length + 15) / 16), 256, 0,
                  (cudaStream_t)stream>>>(b, length, key_out, flags);
  return (int)cudaGetLastError();
}
