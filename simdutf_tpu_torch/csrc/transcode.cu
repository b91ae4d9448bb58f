// Fixed-rate UTF-8 <-> UTF-16 transcodes of one census class each, with
// the Pallas kernels' class flag ("some in-range element lies outside the
// class"):
//   utf8_to_utf16_fixed<ASCII | U2 | U3 | U4, BE> replaces _widen_kernel
//     (simdutf_tpu/kernels/transcode.py ascii_widen_utf16, pallas_call
//     :82), _uniform2_kernel (uniform2_utf8_to_utf16, :211),
//     _uniform3_kernel (_uniform3_pallas, :312) and _wordmap_kernel's
//     "u8_to_u16" variant (astral_wordmap, :1127: 4 bytes -> one
//     surrogate pair);
//   utf16_to_utf8_fixed<ASCII | U2 | U3, BE> replaces _narrow_kernel
//     (ascii_narrow_utf8, :133), _rev2_kernel (uniform2_utf16_to_utf8,
//     :385) and _rev3_kernel (_rev3_pallas, :472).
//
// Floor: HBM bytes, one read of the in-range input and one write of the
// whole output buffer (3 bytes per input byte for the widen family, 2 + 3
// per unit for the narrow one). Each thread step is one to three 16-byte
// loads and stores: 16 bytes -> 16 units (ASCII), 16 bytes -> 8 units
// (U2, U4), 48 bytes -> 16 units (U3); 16 units -> 16 bytes, 8 units -> 16
// bytes, 16 units -> 48 bytes. 48 is a multiple of 16, so every access of
// a 16-byte aligned buffer stays aligned; a ragged last step, or a buffer
// that is not aligned, takes byte accesses.
//
// Where the TPU kernels lean on zero padding and a host trim, these take
// the length: elements at/after it read as zero and never flag (a
// character whose first byte is in range is checked with them, as the
// Pallas kernels check it against their zero padding), and the kernels
// write the whole output buffer, the class's output then zeros, in the
// same pass (no separate fill). The TPU grid carries the flag in one SMEM
// word across its sequential steps; here every block ORs its threads'
// flags with __syncthreads_or and makes one atomicOr. Output offsets are
// 64-bit: 3n bytes exceed 2^31 for buffers above 2^31 / 3 units.
#include "utf16.cuh"

namespace {

constexpr int ASCII = 1, U2 = 2, U3 = 3, U4 = 4;  // UTF-8 bytes a character

// w[i] = the 4 bytes at p0 + 4i for i in [0, 4K), zero at/after lim
template <int K>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ b,
                                           long long p0, long long lim,
                                           bool vec, uint32_t (&w)[4 * K]) {
  if (vec && p0 + 16 * K <= lim) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint4 m = reinterpret_cast<const uint4*>(b + p0)[i];
      w[4 * i] = m.x;
      w[4 * i + 1] = m.y;
      w[4 * i + 2] = m.z;
      w[4 * i + 3] = m.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * K; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long q = p0 + 4 * i + j;
        if (q < lim) v |= (uint32_t)b[q] << (8 * j);
      }
      w[i] = v;
    }
  }
}

// the 16K bytes of w to out + o0; bytes at/after lim are dropped
template <int K>
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ out,
                                            long long o0, long long lim,
                                            bool vec,
                                            const uint32_t (&w)[4 * K]) {
  if (vec && o0 + 16 * K <= lim) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      reinterpret_cast<uint4*>(out + o0)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < 16 * K; ++i)
      if (o0 + i < lim) out[o0 + i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

template <int N>
__device__ __forceinline__ int byte_at(const uint32_t (&w)[N], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
}

// out: n units; units [0, length / CLS * UPC) decoded, the rest zero (UPC:
// units per character, 2 for the 4-byte class's surrogate pair)
template <int CLS, bool BE>
__global__ void __launch_bounds__(256)
    utf8_to_utf16_fixed(const uint8_t* __restrict__ b, long long n,
                        long long length, uint8_t* __restrict__ out,
                        int* __restrict__ flag) {
  constexpr int UPC = CLS == U4 ? 2 : 1;
  constexpr int CH = CLS == U2 ? 8 : CLS == U4 ? 4 : 16;  // chars per step
  constexpr int UNITS = CH * UPC;                          // units per step
  constexpr int KIN = CH * CLS / 16, KOUT = UNITS * 2 / 16;
  const bool vec = su::aligned16(b) && su::aligned16(out);
  const long long cnt = length / CLS * UPC, steps = (n + UNITS - 1) / UNITS;
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * CH * CLS, q0 = k * UNITS;
    uint32_t o[4 * KOUT] = {};
    if (p0 < length) {
      uint32_t x[4 * KIN];
      load_bytes<KIN>(b, p0, length, vec, x);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c0 = byte_at(x, CLS * j);
        int u[UPC];
        bool ok;
        if constexpr (CLS == ASCII) {
          u[0] = c0;
          ok = c0 < 0x80;
        } else if constexpr (CLS == U2) {
          const int c1 = byte_at(x, 2 * j + 1);
          u[0] = ((c0 & 0x1F) << 6) | (c1 & 0x3F);
          ok = (c0 & 0xE0) == 0xC0 && c0 >= 0xC2 && su::is_cont(c1);
        } else if constexpr (CLS == U3) {
          // _u8_3byte_char: structure, overlong and surrogate checks
          const int c1 = byte_at(x, 3 * j + 1), c2 = byte_at(x, 3 * j + 2);
          u[0] = ((c0 & 0x0F) << 12) | ((c1 & 0x3F) << 6) | (c2 & 0x3F);
          ok = (c0 & 0xF0) == 0xE0 && su::is_cont(c1) && su::is_cont(c2) &&
               u[0] >= 0x800 && !su::is_sur(u[0]);
        } else {  // _u8_4byte_cp: structure and range; then _astral_pair
          const int c1 = byte_at(x, 4 * j + 1), c2 = byte_at(x, 4 * j + 2),
                    c3 = byte_at(x, 4 * j + 3);
          const int cp = ((c0 & 0x07) << 18) | ((c1 & 0x3F) << 12) |
                         ((c2 & 0x3F) << 6) | (c3 & 0x3F);
          ok = su::is_lead4(c0) && su::is_cont(c1) && su::is_cont(c2) &&
               su::is_cont(c3) && cp >= 0x10000 && cp <= 0x10FFFF;
          u[0] = 0xD7C0 + (cp >> 10);  // 0xD800 + ((cp - 0x10000) >> 10)
          u[1] = 0xDC00 + (cp & 0x3FF);
        }
        bad |= !ok && p0 + CLS * j < length;
#pragma unroll
        for (int i = 0; i < UPC; ++i) {
          const int at = UPC * j + i;
          int v = q0 + at < cnt ? u[i] : 0;
          if (BE) v = su::bswap16(v);
          o[at >> 1] |= (uint32_t)v << (16 * (at & 1));
        }
      }
    }
    store_bytes<KOUT>(out, 2 * q0, 2 * n, vec, o);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// out: 3n bytes; bytes [0, CLS * length) encoded, the rest zero. The ASCII
// class keeps each unit's low byte (u & 0xFF), as the plain branch does.
template <int CLS, bool BE>
__global__ void __launch_bounds__(256)
    utf16_to_utf8_fixed(const uint8_t* __restrict__ w, long long n,
                        long long length, uint8_t* __restrict__ out,
                        int* __restrict__ flag) {
  constexpr int UNITS = CLS == U2 ? 8 : 16;  // input units per step
  constexpr int KIN = UNITS * 2 / 16, KOUT = UNITS * CLS / 16;
  const bool vec = su::aligned16(w) && su::aligned16(out);
  const long long steps = (3 * n + UNITS * CLS - 1) / (UNITS * CLS);
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long q0 = k * UNITS;
    uint32_t o[4 * KOUT] = {};
    if (q0 < length) {
      uint32_t x[4 * KIN];
      load_bytes<KIN>(w, 2 * q0, 2 * length, vec, x);
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        int u = (x[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
        if (BE) u = su::bswap16(u);
        const bool in = q0 + j < length;
        int by[CLS];
        bool ok;
        if constexpr (CLS == ASCII) {
          ok = u < 0x80;
          by[0] = u & 0xFF;
        } else if constexpr (CLS == U2) {
          ok = u >= 0x80 && u <= 0x7FF;
          by[0] = ((u >> 6) | 0xC0) & 0xFF;
          by[1] = (u & 0x3F) | 0x80;
        } else {
          ok = u >= 0x800 && !su::is_sur(u);
          by[0] = 0xE0 | (u >> 12);
          by[1] = 0x80 | ((u >> 6) & 0x3F);
          by[2] = 0x80 | (u & 0x3F);
        }
        bad |= !ok && in;
        if (in) {
#pragma unroll
          for (int i = 0; i < CLS; ++i) {
            const int at = CLS * j + i;
            o[at >> 2] |= (uint32_t)by[i] << (8 * (at & 3));
          }
        }
      }
    }
    store_bytes<KOUT>(out, k * UNITS * CLS, 3 * n, vec, o);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

template <int CLS>
int widen(const uint8_t* b, long long n, long long length, int be,
          uint16_t* out, int* flag, void* stream) {
  const int grid = su::grid_for((n + 15) / 16);
  auto* o = reinterpret_cast<uint8_t*>(out);
  if (be)
    utf8_to_utf16_fixed<CLS, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        b, n, length, o, flag);
  else
    utf8_to_utf16_fixed<CLS, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        b, n, length, o, flag);
  return (int)cudaGetLastError();
}

template <int CLS>
int narrow(const uint16_t* w, long long n, long long length, int be,
           uint8_t* out, int* flag, void* stream) {
  const int grid = su::grid_for((3 * n + 47) / 48);
  auto* x = reinterpret_cast<const uint8_t*>(w);
  if (be)
    utf16_to_utf8_fixed<CLS, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, out, flag);
  else
    utf16_to_utf8_fixed<CLS, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, out, flag);
  return (int)cudaGetLastError();
}

}  // namespace

// b: n bytes, out: n units, flag: one zeroed int32 on the device. Returns
// cudaGetLastError().
extern "C" int ascii_widen_utf16(const uint8_t* b, long long n,
                                 long long length, int be, uint16_t* out,
                                 int* flag, void* stream) {
  return widen<ASCII>(b, n, length, be, out, flag, stream);
}

extern "C" int uniform2_utf8_to_utf16(const uint8_t* b, long long n,
                                      long long length, int be, uint16_t* out,
                                      int* flag, void* stream) {
  return widen<U2>(b, n, length, be, out, flag, stream);
}

extern "C" int uniform3_utf8_to_utf16(const uint8_t* b, long long n,
                                      long long length, int be, uint16_t* out,
                                      int* flag, void* stream) {
  return widen<U3>(b, n, length, be, out, flag, stream);
}

extern "C" int astral_utf8_to_utf16(const uint8_t* b, long long n,
                                    long long length, int be, uint16_t* out,
                                    int* flag, void* stream) {
  return widen<U4>(b, n, length, be, out, flag, stream);
}

// w: n units, out: 3n bytes, flag: one zeroed int32 on the device. Returns
// cudaGetLastError().
extern "C" int ascii_narrow_utf8(const uint16_t* w, long long n,
                                 long long length, int be, uint8_t* out,
                                 int* flag, void* stream) {
  return narrow<ASCII>(w, n, length, be, out, flag, stream);
}

extern "C" int uniform2_utf16_to_utf8(const uint16_t* w, long long n,
                                      long long length, int be, uint8_t* out,
                                      int* flag, void* stream) {
  return narrow<U2>(w, n, length, be, out, flag, stream);
}

extern "C" int uniform3_utf16_to_utf8(const uint16_t* w, long long n,
                                      long long length, int be, uint8_t* out,
                                      int* flag, void* stream) {
  return narrow<U3>(w, n, length, be, out, flag, stream);
}
