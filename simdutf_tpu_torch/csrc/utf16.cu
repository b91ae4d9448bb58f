// utf16_first_bad: least position of a lone surrogate in a UTF-16 buffer
// (replaces the Pallas kernel _utf16_kernel behind
// simdutf_tpu/kernels/utf16_kernels.utf16_first_bad).
// utf16_count: length-masked counts (replaces _count16_kernel behind
// utf16_kernels.utf16_reduce): code points, or UTF-8 bytes.
// utf16_to_well_formed: every lone surrogate below the length replaced by
// U+FFFD (replaces _wf_kernel behind utf16_kernels.utf16_to_well_formed).
//
// Floor: HBM bytes, one streaming read of 2 * `length` bytes each. The TPU
// kernels carry the running result in an output block across a sequential
// grid, and the first-bad kernel relies on zero tiles around the data for
// its neighbours; Hopper blocks run in no order, so each warp reduces and
// makes one atomic update (atomicMin on the position, atomicAdd on the
// count), and the kernels take the length: a unit stored at `length` is
// never read as the low half of a pair. Chunks without a surrogate skip
// the pairing checks.
#include "utf16.cuh"

namespace {

__global__ void __launch_bounds__(256)
    first_bad_kernel(const uint16_t* __restrict__ w, long long length, int be,
                     unsigned long long* __restrict__ out) {
  const bool vec = su::aligned16(w);
  const long long chunks = (length + 7) / 8;
  unsigned best = (unsigned)su::BIG;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 8;
    int u[10];
    su::load_units10(w, p0, length, vec, be, u);
    bool any = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) any |= su::is_sur(u[1 + j]);
    if (!any) continue;
    // units at/after the length read as zero, which no check flags
#pragma unroll
    for (int j = 7; j >= 0; --j)
      if (su::lone(u[j], u[1 + j], u[2 + j])) best = (unsigned)(p0 + j);
    if (best != (unsigned)su::BIG) break;  // later chunks lie further on
  }
  best = __reduce_min_sync(su::FULL, best);
  if ((threadIdx.x & 31) == 0 && best != (unsigned)su::BIG)
    atomicMin(out, (unsigned long long)best);
}

// mode 0: code points (units that are not low surrogates); mode 1: UTF-8
// bytes in the scalar/utf16.h:80-94 form (each surrogate counts 2)
__global__ void __launch_bounds__(256)
    count_kernel(const uint16_t* __restrict__ w, long long length, int be,
                 int mode, unsigned long long* __restrict__ out) {
  const bool vec = su::aligned16(w);
  const long long chunks = (length + 7) / 8;
  unsigned long long total = 0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 8;
    int u[8];
    su::load_units8(w, p0, length, vec, be, u);
    int s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (p0 + j < length)
        s += mode == 0 ? !su::is_lo(u[j]) : su::utf8_bytes(u[j]);
    total += s;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(su::FULL, total, d);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(out, total);
}

// Elementwise over the whole n-unit buffer, 8 units per thread with the
// one-unit halo each side: in-range units are read in native order (zero
// at/after the length, so a high at length-1 has no partner), a lone one
// becomes U+FFFD in the buffer's byte order and every other unit, those
// at/after the length included, keeps its stored value. Floor: HBM bytes,
// one read and one write of 2n bytes, in 16-byte loads and stores.
__global__ void __launch_bounds__(256)
    well_formed_kernel(const uint16_t* __restrict__ w, long long n,
                       long long length, int be, uint16_t* __restrict__ out) {
  const bool vec = su::aligned16(w) && su::aligned16(out);
  const int fffd = be ? 0xFDFF : 0xFFFD;
  const long long chunks = (n + 7) / 8;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 8;
    int raw[8];
    su::load_units8(w, p0, n, vec, false, raw);
    int u[10];  // native units at p0 - 1 .. p0 + 8, zero outside [0, length)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      u[1 + j] = p0 + j < length ? (be ? su::bswap16(raw[j]) : raw[j]) : 0;
    const int prv = p0 >= 1 && p0 - 1 < length ? w[p0 - 1] : 0;
    const int nxt = p0 + 8 < length ? w[p0 + 8] : 0;
    u[0] = be ? su::bswap16(prv) : prv;
    u[9] = be ? su::bswap16(nxt) : nxt;
    int o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = p0 + j < length && su::lone(u[j], u[1 + j], u[2 + j]) ? fffd : raw[j];
    if (vec && p0 + 8 <= n) {
      uint4 m;
      m.x = (uint32_t)o[0] | ((uint32_t)o[1] << 16);
      m.y = (uint32_t)o[2] | ((uint32_t)o[3] << 16);
      m.z = (uint32_t)o[4] | ((uint32_t)o[5] << 16);
      m.w = (uint32_t)o[6] | ((uint32_t)o[7] << 16);
      *reinterpret_cast<uint4*>(out + p0) = m;
    } else {
      for (int j = 0; j < 8 && p0 + j < n; ++j) out[p0 + j] = (uint16_t)o[j];
    }
  }
}

}  // namespace

// out: one int64 on the device set to BIG. Returns cudaGetLastError().
extern "C" int utf16_first_bad(const uint16_t* w, long long length, int be,
                               unsigned long long* out, void* stream) {
  first_bad_kernel<<<su::grid_for((length + 7) / 8), 256, 0,
                     (cudaStream_t)stream>>>(w, length, be, out);
  return (int)cudaGetLastError();
}

// out: one zeroed int64 on the device. Returns cudaGetLastError().
extern "C" int utf16_count(const uint16_t* w, long long length, int be,
                           int mode, unsigned long long* out, void* stream) {
  count_kernel<<<su::grid_for((length + 7) / 8), 256, 0,
                 (cudaStream_t)stream>>>(w, length, be, mode, out);
  return (int)cudaGetLastError();
}

// out: n units. Returns cudaGetLastError().
extern "C" int utf16_to_well_formed(const uint16_t* w, long long n,
                                    long long length, int be, uint16_t* out,
                                    void* stream) {
  well_formed_kernel<<<su::grid_for((n + 7) / 8), 256, 0,
                       (cudaStream_t)stream>>>(w, n, length, be, out);
  return (int)cudaGetLastError();
}
