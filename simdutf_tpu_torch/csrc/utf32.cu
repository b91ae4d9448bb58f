// utf32_first_bad: least position of an invalid word in a UTF-32 buffer
// (replaces the Pallas kernel _utf32_validate_kernel behind
// simdutf_tpu/kernels/validate.utf32_first_bad).
// utf32_count: length-masked counts (replaces _utf32_len_kernel behind
// validate.utf32_reduce): UTF-8 bytes or UTF-16 units of the words, with the
// length ladder of scalar/utf32.h (a word >= 2^31 counts above every
// threshold: 4 bytes, 2 units).
//
// Floor: HBM bytes, one streaming read of 4 * `length` bytes each. The TPU
// kernels carry the running result in an output block across a sequential
// grid of (8, 512)-word tiles; Hopper blocks run in no order, so each
// thread walks its chunks of 8 words (two 16-byte loads) in a grid-stride
// loop, each warp reduces, and one lane makes one atomic update (atomicMin
// on the position, atomicAdd on the count). The first-bad walk stops at a
// thread's first bad chunk: its later chunks lie further on.
#include "utf32.cuh"

namespace {

__global__ void __launch_bounds__(256)
    first_bad_kernel(const int* __restrict__ w, long long length,
                     unsigned long long* __restrict__ out) {
  const bool vec = su::aligned16w(w);
  const long long chunks = (length + 7) / 8;
  unsigned best = (unsigned)su::BIG;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 8;
    int u[8];
    su::load_words8(w, p0, length, vec, u);  // zero past the length: valid
#pragma unroll
    for (int j = 7; j >= 0; --j)
      if (su::bad32(u[j])) best = (unsigned)(p0 + j);
    if (best != (unsigned)su::BIG) break;
  }
  best = __reduce_min_sync(su::FULL, best);
  if ((threadIdx.x & 31) == 0 && best != (unsigned)su::BIG)
    atomicMin(out, (unsigned long long)best);
}

// mode 0: UTF-8 bytes; mode 1: UTF-16 units
__global__ void __launch_bounds__(256)
    count_kernel(const int* __restrict__ w, long long length, int mode,
                 unsigned long long* __restrict__ out) {
  const bool vec = su::aligned16w(w);
  const long long chunks = (length + 7) / 8;
  unsigned long long total = 0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 8;
    int u[8];
    su::load_words8(w, p0, length, vec, u);
    int s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned x = (unsigned)u[j];
      const int c = mode == 0 ? 1 + (x > 0x7Fu) + (x > 0x7FFu) + (x > 0xFFFFu)
                              : 1 + (x > 0xFFFFu);
      s += p0 + j < length ? c : 0;
    }
    total += s;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(su::FULL, total, d);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(out, total);
}

}  // namespace

// out: one int64 on the device set to BIG. Returns cudaGetLastError().
extern "C" int utf32_first_bad(const int* w, long long length,
                               unsigned long long* out, void* stream) {
  first_bad_kernel<<<su::grid_for((length + 7) / 8), 256, 0,
                     (cudaStream_t)stream>>>(w, length, out);
  return (int)cudaGetLastError();
}

// out: one zeroed int64 on the device. Returns cudaGetLastError().
extern "C" int utf32_count(const int* w, long long length, int mode,
                           unsigned long long* out, void* stream) {
  count_kernel<<<su::grid_for((length + 7) / 8), 256, 0,
                 (cudaStream_t)stream>>>(w, length, mode, out);
  return (int)cudaGetLastError();
}
