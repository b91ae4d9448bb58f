// utf8_first_event: exact first UTF-8 error of a buffer (replaces the Pallas
// kernels _utf8_kernel_len / _utf8_kernel behind
// simdutf_tpu/kernels/validate.utf8_first_event_len / utf8_first_event).
// utf8_count: length-masked counts (replaces _count_kernel behind
// validate.utf8_count / utf8_utf16_length / latin1_utf8_length).
//
// Floor: HBM bytes, one streaming read of `length` bytes each (the count
// reaches it; the first-event lattice is bound by per-byte work). The TPU
// kernels carry the running minimum in an output block across a
// sequential grid; Hopper blocks run in no order, so each warp reduces and
// makes one atomic update (atomicMin on the 64-bit key pos << 8 | code,
// atomicAdd on the count). Bytes at/after `length` read as zero, so a
// sequence cut at the length reports TOO_SHORT at its lead.
#include "utf8.cuh"

namespace {

__global__ void __launch_bounds__(256)
    first_event_kernel(const uint8_t* __restrict__ b, long long length,
                       unsigned long long* __restrict__ out) {
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long chunks = (length + 15) / 16;
  unsigned long long key = su::NO_EVENT;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 16;
    int c[24];
    su::load_window24(b, p0, length, vec, c);
    int any_high = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) any_high |= c[4 + j];
    if (any_high < 0x80) continue;  // events sit only on bytes >= 0x80
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
  key = su::warp_min_u64(key);
  if ((threadIdx.x & 31) == 0 && key != su::NO_EVENT) atomicMin(out, key);
}

// per-byte count of the three modes
__device__ __forceinline__ int count_byte(int x, int mode) {
  if (mode == 2) return 1 + (x >= 0x80);        // UTF-8 bytes from Latin-1
  int r = !su::is_cont(x);                      // code points
  if (mode == 1) r += x >= 0xF0;                // + second UTF-16 unit
  return r;
}

__global__ void __launch_bounds__(256)
    count_kernel(const uint8_t* __restrict__ b, long long length, int mode,
                 unsigned long long* __restrict__ out) {
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long chunks = (length + 15) / 16;
  unsigned long long total = 0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 16;
    if (vec && p0 + 16 <= length) {
      // four bytes per 32-bit word: bit 7 of each byte carries the test
      const uint4 m = *reinterpret_cast<const uint4*>(b + p0);
      const uint32_t w[4] = {m.x, m.y, m.z, m.w};
      int s = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = w[i];
        const uint32_t high = x & 0x80808080u;
        if (mode == 2) {
          s += 4 + __popc(high);
        } else {
          s += 4 - __popc(high & ~(x << 1));  // minus continuation bytes
          if (mode == 1) s += __popc(high & (x << 1) & (x << 2) & (x << 3));
        }
      }
      total += s;
    } else {
      for (int j = 0; j < 16 && p0 + j < length; ++j)
        total += count_byte(b[p0 + j], mode);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(su::FULL, total, d);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(out, total);
}

}  // namespace

// out_key: one int64 on the device set to BIG << 8. Returns
// cudaGetLastError().
extern "C" int utf8_first_event(const uint8_t* b, long long length,
                                unsigned long long* out_key, void* stream) {
  first_event_kernel<<<su::grid_for((length + 15) / 16), 256, 0,
                       (cudaStream_t)stream>>>(b, length, out_key);
  return (int)cudaGetLastError();
}

// mode 0: code points, 1: UTF-16 units, 2: UTF-8 bytes of Latin-1 input.
// out: one zeroed int64 on the device. Returns cudaGetLastError().
extern "C" int utf8_count(const uint8_t* b, long long length, int mode,
                          unsigned long long* out, void* stream) {
  count_kernel<<<su::grid_for((length + 15) / 16), 256, 0,
                 (cudaStream_t)stream>>>(b, length, mode, out);
  return (int)cudaGetLastError();
}
