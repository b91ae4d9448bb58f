// Fixed-rate transcodes into and out of UTF-32, one census class each, with
// the Pallas kernels' class flag ("some in-range element lies outside the
// class"). Every function of simdutf_tpu/kernels/transcode.py named below
// is the file's; the line is its pallas_call.
//   utf8_to_utf32_fixed<ASCII | U2 | U3 | U4> replaces _l1_32_kernel
//     (_l1_32_pallas, :527; the Latin-1 widen, which also serves the ASCII
//     UTF-8 class), _u2_32_kernel (_u2_32_pallas, :815), _u3_32_kernel
//     (_u3_32_pallas, :937) and _wordmap_kernel's "u8_to_u32" variant
//     (astral_wordmap, :1127);
//   utf32_to_utf8_fixed<U2 | U3 | U4> replaces _rev2_32_kernel
//     (_rev2_32_pallas, :883), _rev3_32_kernel (_rev3_32_pallas, :1005) and
//     _wordmap_kernel's "u32_to_u8" variant;
//   utf16_to_utf32_fixed<BMP | ASTRAL, BE> replaces bmp_widen_utf32 in both
//     its forms, _bmp_widen_kernel (_bmp_widen_pallas, :632) and the
//     butterfly _bmp_widen_bf_kernel (_bmp_widen_bf, :612), and
//     _wordmap_kernel's "u16pair_to_u32" variant;
//   utf32_to_utf16_fixed<BMP | ASTRAL, BE> replaces bmp_narrow_utf16 in both
//     its forms, _bmp_narrow_kernel (_bmp_narrow_pallas, :746) and
//     _bmp_narrow_bf_kernel (_bmp_narrow_bf, :726), and _wordmap_kernel's
//     "u32_to_u16pair" variant.
//
// Floor: HBM bytes, one read of the in-range input and one write of the
// whole output buffer (4 bytes a word; 4n bytes of UTF-8 or UTF-16 from n
// words). A thread step is four code points, so each side of a step is
// one contiguous access across the warp: 4/8/12/16 bytes of UTF-8 or 8/16
// bytes of UTF-16 against 16 bytes of words. Every access but the 12-byte
// one (three 4-byte accesses) is a single vector access at a multiple of
// its own size; a ragged last step, or a buffer not so aligned, takes
// byte accesses.
//
// As in transcode.cu, where the TPU kernels lean on zero padding and a
// host trim these take the length: elements at/after it read as zero and
// never flag (a character whose first element is in range is checked with
// them), and the kernels write the whole output buffer, the class's output
// then zeros, in the same pass. Every block ORs its threads' flags with
// __syncthreads_or and makes one atomicOr. Offsets are 64-bit: 4n bytes
// pass 2^31 once n passes 2^29 words.
#include "utf16.cuh"

namespace {

constexpr int ASCII = 1, U2 = 2, U3 = 3, U4 = 4;  // UTF-8 bytes a code point
constexpr int BMP = 1, ASTRAL = 2;                // UTF-16 units a code point

// alignment of a K-word access at a multiple of 4K bytes
template <int K>
__device__ __forceinline__ bool aligned_for(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (K == 3 ? 3 : 4 * K - 1)) == 0;
}

// w[i] = the 4 bytes at p0 + 4i for i in [0, K), zero at/after lim
template <int K>
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ b,
                                           long long p0, long long lim,
                                           bool vec, uint32_t (&w)[K]) {
  if (vec && p0 + 4 * K <= lim) {
    const uint8_t* a = b + p0;
    if constexpr (K == 4) {
      const uint4 m = *reinterpret_cast<const uint4*>(a);
      w[0] = m.x, w[1] = m.y, w[2] = m.z, w[3] = m.w;
    } else if constexpr (K == 2) {
      const uint2 m = *reinterpret_cast<const uint2*>(a);
      w[0] = m.x, w[1] = m.y;
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) w[i] = reinterpret_cast<const uint32_t*>(a)[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
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

// the 4K bytes of w to out + o0; bytes at/after lim are dropped
template <int K>
__device__ __forceinline__ void store_words(uint8_t* __restrict__ out,
                                            long long o0, long long lim,
                                            bool vec, const uint32_t (&w)[K]) {
  if (vec && o0 + 4 * K <= lim) {
    uint8_t* a = out + o0;
    if constexpr (K == 4) {
      *reinterpret_cast<uint4*>(a) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (K == 2) {
      *reinterpret_cast<uint2*>(a) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) reinterpret_cast<uint32_t*>(a)[i] = w[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * K; ++i)
      if (o0 + i < lim) out[o0 + i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

template <int K>
__device__ __forceinline__ int byte_at(const uint32_t (&w)[K], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
}

__device__ __forceinline__ void flag_block(bool bad, int* flag) {
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// out: n words; words [0, length / CLS) decoded, the rest zero. A step
// reads 4 * CLS bytes and writes 16.
template <int CLS>
__global__ void __launch_bounds__(256)
    utf8_to_utf32_fixed(const uint8_t* __restrict__ b, long long n,
                        long long length, uint8_t* __restrict__ out,
                        int* __restrict__ flag) {
  const bool vin = aligned_for<CLS>(b), vout = aligned_for<4>(out);
  const long long cnt = length / CLS, steps = (n + 3) / 4;
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 4 * CLS, q0 = 4 * k;
    uint32_t o[4] = {};
    if (p0 < length) {
      uint32_t x[CLS];
      load_words<CLS>(b, p0, length, vin, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = byte_at(x, CLS * j);
        int cp;
        bool ok;
        if constexpr (CLS == ASCII) {  // Latin-1 bytes widen all the same
          cp = c0;
          ok = c0 < 0x80;
        } else if constexpr (CLS == U2) {  // _u2_32_core
          const int c1 = byte_at(x, 2 * j + 1);
          cp = ((c0 & 0x1F) << 6) | (c1 & 0x3F);
          ok = (c0 & 0xE0) == 0xC0 && c0 >= 0xC2 && su::is_cont(c1);
        } else if constexpr (CLS == U3) {  // _uniform3_chars
          const int c1 = byte_at(x, 3 * j + 1), c2 = byte_at(x, 3 * j + 2);
          cp = ((c0 & 0x0F) << 12) | ((c1 & 0x3F) << 6) | (c2 & 0x3F);
          ok = (c0 & 0xF0) == 0xE0 && su::is_cont(c1) && su::is_cont(c2) &&
               cp >= 0x800 && !su::is_sur(cp);
        } else {  // _u8_4byte_cp
          const int c1 = byte_at(x, 4 * j + 1), c2 = byte_at(x, 4 * j + 2),
                    c3 = byte_at(x, 4 * j + 3);
          cp = ((c0 & 0x07) << 18) | ((c1 & 0x3F) << 12) |
               ((c2 & 0x3F) << 6) | (c3 & 0x3F);
          ok = su::is_lead4(c0) && su::is_cont(c1) && su::is_cont(c2) &&
               su::is_cont(c3) && cp >= 0x10000 && cp <= 0x10FFFF;
        }
        bad |= !ok && p0 + CLS * j < length;
        o[j] = q0 + j < cnt ? (uint32_t)cp : 0u;
      }
    }
    store_words<4>(out, 4 * q0, 4 * n, vout, o);
  }
  flag_block(bad, flag);
}

// out: 4n bytes; bytes [0, CLS * length) encoded, the rest zero. A step
// reads 16 bytes of words and writes 4 * CLS bytes. Each byte is the plain
// branch's: the word shifted arithmetically, its low 8 bits kept.
template <int CLS>
__global__ void __launch_bounds__(256)
    utf32_to_utf8_fixed(const uint8_t* __restrict__ w, long long n,
                        long long length, uint8_t* __restrict__ out,
                        int* __restrict__ flag) {
  const bool vin = aligned_for<4>(w), vout = aligned_for<CLS>(out);
  const long long steps = (n + CLS - 1) / CLS;  // 4n bytes, 4 * CLS a step
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long q0 = 4 * k;
    uint32_t o[CLS] = {};
    if (q0 < length) {
      uint32_t x[4];
      load_words<4>(w, 4 * q0, 4 * length, vin, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t cu = x[j];
        const int c = (int)cu;
        const bool in = q0 + j < length;
        int by[CLS];
        bool ok;
        if constexpr (CLS == U2) {  // _rev2_32_core
          ok = cu >= 0x80 && cu <= 0x7FF;
          by[0] = (c >> 6) | 0xC0;
          by[1] = (c & 0x3F) | 0x80;
        } else if constexpr (CLS == U3) {  // _rev3_32_core
          ok = cu >= 0x800 && cu <= 0xFFFF && !su::is_sur(c);
          by[0] = (c >> 12) | 0xE0;
          by[1] = ((c >> 6) & 0x3F) | 0x80;
          by[2] = (c & 0x3F) | 0x80;
        } else {  // _wordmap_kernel, "u32_to_u8"
          ok = cu >= 0x10000 && cu <= 0x10FFFF;
          by[0] = (c >> 18) | 0xF0;
          by[1] = ((c >> 12) & 0x3F) | 0x80;
          by[2] = ((c >> 6) & 0x3F) | 0x80;
          by[3] = (c & 0x3F) | 0x80;
        }
        bad |= !ok && in;
        if (in) {
#pragma unroll
          for (int i = 0; i < CLS; ++i) {
            const int at = CLS * j + i;
            o[at >> 2] |= (uint32_t)(by[i] & 0xFF) << (8 * (at & 3));
          }
        }
      }
    }
    store_words<CLS>(out, 4 * CLS * k, 4 * n, vout, o);
  }
  flag_block(bad, flag);
}

// out: n words; words [0, length / UPC) decoded, the rest zero. A step
// reads 8 (BMP) or 16 (ASTRAL) bytes of units and writes 16.
template <int UPC, bool BE>
__global__ void __launch_bounds__(256)
    utf16_to_utf32_fixed(const uint8_t* __restrict__ w, long long n,
                         long long length, uint8_t* __restrict__ out,
                         int* __restrict__ flag) {
  constexpr int KIN = 2 * UPC;  // input words a step
  const bool vin = aligned_for<KIN>(w), vout = aligned_for<4>(out);
  const long long cnt = length / UPC, steps = (n + 3) / 4;
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long u0 = 4 * UPC * k, q0 = 4 * k;
    uint32_t o[4] = {};
    if (u0 < length) {
      uint32_t x[KIN];
      load_words<KIN>(w, 2 * u0, 2 * length, vin, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int cp;
        bool ok;
        if constexpr (UPC == BMP) {  // _bmp_widen_planes
          int u = (x[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
          if (BE) u = su::bswap16(u);
          cp = u;
          ok = !su::is_sur(u);
        } else {  // _wordmap_kernel, "u16pair_to_u32"
          int h = x[j] & 0xFFFF, l = x[j] >> 16;
          if (BE) h = su::bswap16(h), l = su::bswap16(l);
          ok = su::is_hi(h) && su::is_lo(l);
          // the plain branch's ((h - 0xD7C0) << 10) | (l & 0x3FF), which is
          // 0x10000 + ((h & 0x3FF) << 10) + (l & 0x3FF) on a valid pair
          cp = (int)(((uint32_t)(h - 0xD7C0) << 10) | (uint32_t)(l & 0x3FF));
        }
        bad |= !ok && u0 + UPC * j < length;
        o[j] = q0 + j < cnt ? (uint32_t)cp : 0u;
      }
    }
    store_words<4>(out, 4 * q0, 4 * n, vout, o);
  }
  flag_block(bad, flag);
}

// out: 2n units; units [0, UPC * length) encoded, the rest zero. A step
// reads 16 bytes of words and writes 8 (BMP) or 16 (ASTRAL) bytes of units.
// Each unit is the low 16 bits of the plain branch's value, byte-swapped
// when BE.
template <int UPC, bool BE>
__global__ void __launch_bounds__(256)
    utf32_to_utf16_fixed(const uint8_t* __restrict__ w, long long n,
                         long long length, uint8_t* __restrict__ out,
                         int* __restrict__ flag) {
  constexpr int KOUT = 2 * UPC;  // output words a step
  const bool vin = aligned_for<4>(w), vout = aligned_for<KOUT>(out);
  const long long steps = (n + KOUT - 1) / KOUT;  // 4n bytes, 4 * KOUT a step
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long q0 = 4 * k;
    uint32_t o[KOUT] = {};
    if (q0 < length) {
      uint32_t x[4];
      load_words<4>(w, 4 * q0, 4 * length, vin, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t cu = x[j];
        const int c = (int)cu;
        const bool in = q0 + j < length;
        bool ok;
        if constexpr (UPC == BMP) {  // _bmp_narrow_from_planes
          ok = cu <= 0xFFFF && !su::is_sur(c);
          int u = c & 0xFFFF;
          if (BE) u = su::bswap16(u);
          if (in) o[j >> 1] |= (uint32_t)u << (16 * (j & 1));
        } else {  // _wordmap_kernel, "u32_to_u16pair" (_astral_pair)
          ok = cu >= 0x10000 && cu <= 0x10FFFF;
          int h = (0xD7C0 + (c >> 10)) & 0xFFFF, l = 0xDC00 + (c & 0x3FF);
          if (BE) h = su::bswap16(h), l = su::bswap16(l);
          if (in) o[j] = (uint32_t)h | ((uint32_t)l << 16);
        }
        bad |= !ok && in;
      }
    }
    store_words<KOUT>(out, 4 * KOUT * k, 4 * n, vout, o);
  }
  flag_block(bad, flag);
}

template <int CLS>
int from_utf8(const uint8_t* b, long long n, long long length, int32_t* out,
              int* flag, void* stream) {
  utf8_to_utf32_fixed<CLS>
      <<<su::grid_for((n + 3) / 4), 256, 0, (cudaStream_t)stream>>>(
          b, n, length, reinterpret_cast<uint8_t*>(out), flag);
  return (int)cudaGetLastError();
}

template <int CLS>
int to_utf8(const int32_t* w, long long n, long long length, uint8_t* out,
            int* flag, void* stream) {
  utf32_to_utf8_fixed<CLS>
      <<<su::grid_for((n + CLS - 1) / CLS), 256, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const uint8_t*>(w), n, length, out, flag);
  return (int)cudaGetLastError();
}

template <int UPC>
int from_utf16(const uint16_t* w, long long n, long long length, int be,
               int32_t* out, int* flag, void* stream) {
  const int grid = su::grid_for((n + 3) / 4);
  auto* x = reinterpret_cast<const uint8_t*>(w);
  auto* o = reinterpret_cast<uint8_t*>(out);
  if (be)
    utf16_to_utf32_fixed<UPC, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, o, flag);
  else
    utf16_to_utf32_fixed<UPC, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, o, flag);
  return (int)cudaGetLastError();
}

template <int UPC>
int to_utf16(const int32_t* w, long long n, long long length, int be,
             uint16_t* out, int* flag, void* stream) {
  const int grid = su::grid_for((n + 2 * UPC - 1) / (2 * UPC));
  auto* x = reinterpret_cast<const uint8_t*>(w);
  auto* o = reinterpret_cast<uint8_t*>(out);
  if (be)
    utf32_to_utf16_fixed<UPC, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, o, flag);
  else
    utf32_to_utf16_fixed<UPC, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, o, flag);
  return (int)cudaGetLastError();
}

}  // namespace

// b: n bytes, out: n words, flag: one zeroed int32 on the device; be is
// unused (UTF-8 has no byte order) and keeps the one signature of the
// fixed-rate entry points. Returns cudaGetLastError().
extern "C" int latin1_widen_utf32(const uint8_t* b, long long n,
                                  long long length, int be, int32_t* out,
                                  int* flag, void* stream) {
  return from_utf8<ASCII>(b, n, length, out, flag, stream);
}

extern "C" int uniform2_utf8_to_utf32(const uint8_t* b, long long n,
                                      long long length, int be, int32_t* out,
                                      int* flag, void* stream) {
  return from_utf8<U2>(b, n, length, out, flag, stream);
}

extern "C" int uniform3_utf8_to_utf32(const uint8_t* b, long long n,
                                      long long length, int be, int32_t* out,
                                      int* flag, void* stream) {
  return from_utf8<U3>(b, n, length, out, flag, stream);
}

extern "C" int astral_utf8_to_utf32(const uint8_t* b, long long n,
                                    long long length, int be, int32_t* out,
                                    int* flag, void* stream) {
  return from_utf8<U4>(b, n, length, out, flag, stream);
}

// w: n words, out: 4n bytes; be unused, as above.
extern "C" int uniform2_utf32_to_utf8(const int32_t* w, long long n,
                                      long long length, int be, uint8_t* out,
                                      int* flag, void* stream) {
  return to_utf8<U2>(w, n, length, out, flag, stream);
}

extern "C" int uniform3_utf32_to_utf8(const int32_t* w, long long n,
                                      long long length, int be, uint8_t* out,
                                      int* flag, void* stream) {
  return to_utf8<U3>(w, n, length, out, flag, stream);
}

extern "C" int astral_utf32_to_utf8(const int32_t* w, long long n,
                                    long long length, int be, uint8_t* out,
                                    int* flag, void* stream) {
  return to_utf8<U4>(w, n, length, out, flag, stream);
}

// w: n units, out: n words.
extern "C" int bmp_widen_utf32(const uint16_t* w, long long n,
                               long long length, int be, int32_t* out,
                               int* flag, void* stream) {
  return from_utf16<BMP>(w, n, length, be, out, flag, stream);
}

extern "C" int astral_utf16_to_utf32(const uint16_t* w, long long n,
                                     long long length, int be, int32_t* out,
                                     int* flag, void* stream) {
  return from_utf16<ASTRAL>(w, n, length, be, out, flag, stream);
}

// w: n words, out: 2n units.
extern "C" int bmp_narrow_utf16(const int32_t* w, long long n,
                                long long length, int be, uint16_t* out,
                                int* flag, void* stream) {
  return to_utf16<BMP>(w, n, length, be, out, flag, stream);
}

extern "C" int astral_utf32_to_utf16(const int32_t* w, long long n,
                                     long long length, int be, uint16_t* out,
                                     int* flag, void* stream) {
  return to_utf16<ASTRAL>(w, n, length, be, out, flag, stream);
}
