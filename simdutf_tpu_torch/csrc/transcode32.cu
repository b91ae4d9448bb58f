// Fixed-rate transcodes into and out of UTF-32, one census class each, with
// the Pallas kernels' class flag ("some in-range element lies outside the
// class"). Every function of simdutf_tpu/kernels/transcode.py named below
// is the file's; the line is its pallas_call.
//   widen32<1> replaces _l1_32_kernel (_l1_32_pallas, :527; the Latin-1
//     widen, which also serves the ASCII UTF-8 class);
//   widen32<2, BE> replaces bmp_widen_utf32 in both its forms,
//     _bmp_widen_kernel (_bmp_widen_pallas, :632) and the butterfly
//     _bmp_widen_bf_kernel (_bmp_widen_bf, :612);
//   utf8_to_utf32_fixed<U2 | U3 | U4> replaces _u2_32_kernel (_u2_32_pallas,
//     :815), _u3_32_kernel (_u3_32_pallas, :937) and _wordmap_kernel's
//     "u8_to_u32" variant (astral_wordmap, :1127);
//   utf32_to_utf8_fixed<U2 | U3 | U4> replaces _rev2_32_kernel
//     (_rev2_32_pallas, :883), _rev3_32_kernel (_rev3_32_pallas, :1005) and
//     _wordmap_kernel's "u32_to_u8" variant;
//   utf16_to_utf32_fixed<BE> (the astral class) replaces _wordmap_kernel's
//     "u16pair_to_u32" variant;
//   utf32_to_utf16_fixed<BMP | ASTRAL, BE> replaces bmp_narrow_utf16 in both
//     its forms, _bmp_narrow_kernel (_bmp_narrow_pallas, :746) and
//     _bmp_narrow_bf_kernel (_bmp_narrow_bf, :726), and _wordmap_kernel's
//     "u32_to_u16pair" variant.
//
// Floor: HBM bytes, one read of the in-range input and one write of the
// whole output buffer (4 bytes a word; 4n bytes of UTF-8 or UTF-16 from n
// words). In the grid-stride kernels a thread step is four code points, so
// each side of a step is one contiguous access across the warp: 8/12/16
// bytes of UTF-8 or 16 bytes of UTF-16 against 16 bytes of words. Every
// access but the 12-byte one (three 4-byte accesses) is a single vector
// access at a multiple of its own size; a ragged last step, or a buffer not
// so aligned, takes byte accesses. widen32 moves whole tiles with the copy
// engine instead (see there).
//
// As in transcode.cu, where the TPU kernels lean on zero padding and a
// host trim these take the length: elements at/after it read as zero and
// never flag (a character whose first element is in range is checked with
// them), and the kernels write the whole output buffer, the class's output
// then zeros, in the same pass. Every block ORs its threads' flags and makes
// at most one atomicOr. Offsets are 64-bit: 4n bytes pass 2^31 once n
// passes 2^29 words.
#include "bulk.cuh"
#include "utf16.cuh"

namespace {

constexpr int U2 = 2, U3 = 3, U4 = 4;  // UTF-8 bytes a code point
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
        if constexpr (CLS == U2) {  // _u2_32_core
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

// out: n words; words [0, length / 2) decoded from unit pairs, the rest
// zero. A step reads 16 bytes of units and writes 16.
template <bool BE>
__global__ void __launch_bounds__(256)
    utf16_to_utf32_fixed(const uint8_t* __restrict__ w, long long n,
                         long long length, uint8_t* __restrict__ out,
                         int* __restrict__ flag) {
  const bool vin = aligned_for<4>(w), vout = aligned_for<4>(out);
  const long long cnt = length / 2, steps = (n + 3) / 4;
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long u0 = 8 * k, q0 = 4 * k;
    uint32_t o[4] = {};
    if (u0 < length) {
      uint32_t x[4];
      load_words<4>(w, 2 * u0, 2 * length, vin, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // _wordmap_kernel, "u16pair_to_u32"
        int h = x[j] & 0xFFFF, l = x[j] >> 16;
        if (BE) h = su::bswap16(h), l = su::bswap16(l);
        const bool ok = su::is_hi(h) && su::is_lo(l);
        // the plain branch's ((h - 0xD7C0) << 10) | (l & 0x3FF), which is
        // 0x10000 + ((h & 0x3FF) << 10) + (l & 0x3FF) on a valid pair
        const int cp = (int)(((uint32_t)(h - 0xD7C0) << 10) | (uint32_t)(l & 0x3FF));
        bad |= !ok && u0 + 2 * j < length;
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

// --- widen32: one element to one word, through the copy engine -----------
//
// widen32<1> widens Latin-1 bytes (the class flag: a byte >= 0x80, the
// ASCII check) and widen32<2, BE> UTF-16 units, byte-swapped when BE (the
// flag: a surrogate). Each moves 5 (bytes) or 6 (units) bytes a word and
// does one compare, so HBM sets its pace, and 80% (75%) of the bytes are
// output written once and never read back.
//
// The design keeps the loads and the stores in flight with no registers
// spent on them. A persistent grid of one wave (the SMs times the blocks
// resident on each) walks whole tiles of WIDEN_TILE words, tile
// blockIdx.x + k * gridDim.x, on bulk.cuh's tile_ring: a ring of
// WIDEN_STAGES stages in shared memory, each an input tile and an output
// tile. Thread 0 keeps the next stages' input in flight with 1-D bulk
// copies (cp.async.bulk, completing on the stage's mbarrier); the threads
// widen from the input tile into the output tile (16-byte shared stores);
// thread 0 writes the output tile out with one bulk copy from shared
// memory, with the L2 evict-first hint, and waits for a stage's copy to
// have read its tile before the stage is written again. A tile wholly at
// or past the length loads nothing and writes zeros.
//
// The edges take the element path of the grid-stride kernels above, steps
// of four words in the same kernel: the head up to the first element whose
// input and output both lie on the 16-byte grid, the elements after the
// last whole tile, and the whole buffer when no such element exists (an
// input view off the grid by other than a multiple of four elements'
// bytes). The host computes the split from the two addresses.
constexpr int WIDEN_THREADS = 256;
constexpr int WIDEN_TILE = 4096;  // words a tile: 16 KB out
constexpr int WIDEN_STAGES = 3;

template <int SRC>
constexpr int widen_smem() {  // dynamic shared memory a block
  return WIDEN_STAGES * (SRC + 4) * WIDEN_TILE;
}

// four elements from the 4 * SRC bytes w to words, native byte order
template <int SRC, bool BE>
__device__ __forceinline__ void widen4(const uint32_t (&w)[SRC],
                                       uint32_t (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (SRC == 1) {
      v[j] = (w[0] >> (8 * j)) & 0xFF;
    } else {
      const int u = (w[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
      v[j] = (uint32_t)(BE ? su::bswap16(u) : u);
    }
  }
}

template <int SRC>
__device__ __forceinline__ bool widen_bad(uint32_t v) {
  return SRC == 1 ? v >= 0x80 : su::is_sur((int)v);
}

// the element path: step k, words [4k, 4k + 4), as the grid-stride
// kernels take it; returns the step's flag
template <int SRC, bool BE>
__device__ __forceinline__ bool widen_step(const uint8_t* __restrict__ x,
                                           long long k, long long n,
                                           long long length, bool vin,
                                           bool vout,
                                           uint8_t* __restrict__ out) {
  const long long q0 = 4 * k;
  uint32_t v[4] = {};
  bool bad = false;
  if (q0 < length) {
    uint32_t w[SRC];
    load_words<SRC>(x, SRC * q0, SRC * length, vin, w);
    widen4<SRC, BE>(w, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (q0 + j >= length) v[j] = 0;  // read as zero already; never flags
      bad |= widen_bad<SRC>(v[j]);
    }
  }
  store_words<4>(out, 4 * q0, 4 * n, vout, v);
  return bad;
}

// one tile from shared ``in`` to shared ``ot``; ``live`` words of it lie
// before the length
template <int SRC, bool BE>
__device__ __forceinline__ bool widen_tile(const uint8_t* in, uint8_t* ot,
                                           long long live) {
  bool bad = false;
#pragma unroll
  for (int r = 0; r < WIDEN_TILE / (4 * WIDEN_THREADS); ++r) {
    const int c = r * WIDEN_THREADS + threadIdx.x;  // words [4c, 4c + 4)
    uint32_t w[SRC], v[4];
    if constexpr (SRC == 1) {
      w[0] = reinterpret_cast<const uint32_t*>(in)[c];
    } else {
      const uint2 m = reinterpret_cast<const uint2*>(in)[c];
      w[0] = m.x, w[1] = m.y;
    }
    widen4<SRC, BE>(w, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * c + j >= live) v[j] = 0;
      bad |= widen_bad<SRC>(v[j]);
    }
    reinterpret_cast<uint4*>(ot)[c] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return bad;
}

// out: n words, words [0, length) widened, the rest zero. Words [head,
// head + ntiles * WIDEN_TILE) go by tiles (head % 4 == 0, and x + SRC *
// head and out + 4 * head are 16-byte aligned), the rest by steps.
template <int SRC, bool BE>
__global__ void __launch_bounds__(WIDEN_THREADS)
    widen32(const uint8_t* __restrict__ x, long long n, long long length,
            uint8_t* __restrict__ out, int* __restrict__ flag,
            long long head, long long ntiles) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  bool bad = false;

  // the edges, by steps: [0, head / 4) and [tail, steps)
  const long long steps = (n + 3) / 4, h4 = head / 4,
                  tail = (head + ntiles * WIDEN_TILE) / 4;
  const bool vin = aligned_for<SRC>(x), vout = aligned_for<4>(out);
  for (long long e = blockIdx.x * (long long)WIDEN_THREADS + tid;
       e < h4 + steps - tail; e += (long long)gridDim.x * WIDEN_THREADS)
    bad |= widen_step<SRC, BE>(x, e < h4 ? e : tail + e - h4, n, length, vin,
                               vout, out);

  // the tiles
  bad |= su::tile_ring<WIDEN_STAGES, WIDEN_TILE, SRC * WIDEN_TILE, 4 * WIDEN_TILE,
                       WIDEN_THREADS>(
      x + SRC * head, out + 4 * head, ntiles, length - head, smem,
      [](const uint8_t* in, uint8_t* ot, long long live) {
        return widen_tile<SRC, BE>(in, ot, live);
      });
  flag_block(bad, flag);
}

// blocks of widen32<SRC, BE> resident on one SM of the current device
// (its shared memory allowed first), and that device's SMs
template <int SRC, bool BE>
cudaError_t widen_resident(int* per_sm, int* sms) {
  static int cached[64];  // by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev]) {
    *per_sm = cached[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(widen32<SRC, BE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           widen_smem<SRC>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, widen32<SRC, BE>, WIDEN_THREADS, widen_smem<SRC>());
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = *per_sm;
  return cudaSuccess;
}

template <int SRC, bool BE>
int widen(const void* x, long long n, long long length, void* out, int* flag,
          void* stream) {
  int per_sm = 0, sms = 0;
  const cudaError_t e = widen_resident<SRC, BE>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  // the first element with input and output on the 16-byte grid: out is
  // (a fresh allocation), so it is a multiple of 4 elements in, which
  // exists when x is off the grid by a multiple of 4 * SRC bytes
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) & 15;
  long long head = (long long)((16 - a) & 15) / SRC, ntiles = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0 && a % (4 * SRC) == 0 &&
      n - head >= WIDEN_TILE)
    ntiles = (n - head) / WIDEN_TILE;
  else
    head = 0;
  const long long edge = head / 4 + (n + 3) / 4 - (head + ntiles * WIDEN_TILE) / 4;
  long long grid = ntiles > (edge + WIDEN_THREADS - 1) / WIDEN_THREADS
                       ? ntiles
                       : (edge + WIDEN_THREADS - 1) / WIDEN_THREADS;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  if (grid < 1) grid = 1;
  widen32<SRC, BE><<<(int)grid, WIDEN_THREADS, widen_smem<SRC>(),
                     (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), n, length, static_cast<uint8_t*>(out),
      flag, head, ntiles);
  return (int)cudaGetLastError();
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

int astral_from_utf16(const uint16_t* w, long long n, long long length, int be,
                      int32_t* out, int* flag, void* stream) {
  const int grid = su::grid_for((n + 3) / 4);
  auto* x = reinterpret_cast<const uint8_t*>(w);
  auto* o = reinterpret_cast<uint8_t*>(out);
  if (be)
    utf16_to_utf32_fixed<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, o, flag);
  else
    utf16_to_utf32_fixed<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
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
  return widen<1, false>(b, n, length, out, flag, stream);
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
  return be ? widen<2, true>(w, n, length, out, flag, stream)
            : widen<2, false>(w, n, length, out, flag, stream);
}

extern "C" int astral_utf16_to_utf32(const uint16_t* w, long long n,
                                     long long length, int be, int32_t* out,
                                     int* flag, void* stream) {
  return astral_from_utf16(w, n, length, be, out, flag, stream);
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

// The launch plan of latin1_widen_utf32 (src 1) or bmp_widen_utf32 (src
// 2) on the current device for a buffer of many tiles: plan[0..5] = grid,
// threads a block, blocks a SM, words a tile, stages, shared memory bytes
// a block. Returns a cudaError_t.
extern "C" int widen32_plan(int src, int* plan) {
  int per_sm = 0, sms = 0;
  const cudaError_t e = src == 1 ? widen_resident<1, false>(&per_sm, &sms)
                                 : widen_resident<2, false>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  plan[0] = per_sm * sms;
  plan[1] = WIDEN_THREADS;
  plan[2] = per_sm;
  plan[3] = WIDEN_TILE;
  plan[4] = WIDEN_STAGES;
  plan[5] = src == 1 ? widen_smem<1>() : widen_smem<2>();
  return 0;
}
