// SWAR first-bad-word scans: the index of the first 4-byte word that holds
// an error, for a host rewind to the exact (code, position).
//
// utf8_swar_first_bad_word replaces the Pallas kernel _swar_kernel /
// _swar_body behind simdutf_tpu/kernels/swar.utf8_swar_first_bad_word;
// ascii_swar_first_bad_word replaces _ascii_swar_kernel
// (ascii_swar_first_bad_word); utf16_swar_first_bad_word replaces
// _utf16_swar_kernel / _utf16_swar_body (utf16_swar_first_bad_word, LE and
// BE). One template, three entry points; the per-word predicates are the
// Pallas ones term for term, zero-byte trick and all, so the word index is
// the Pallas one on its zero-padded layout, false positives included.
//
// Floor: HBM bytes, one streaming read of the in-range input; each word is
// a few dozen integer operations, far below the card's integer rate. The
// TPU kernel reads (BR, 128)-word tiles with halo blocks of its neighbours
// and carries the running minimum across a sequential grid. Here a thread
// takes 4 words (one 16-byte load) and reads the words either side straight
// from global memory (they are in L1/L2 already), masked by the length, so
// a word at a block boundary sees its neighbour's raw word. Each thread's
// first flagged word is its minimum (grid-stride steps only go up); each
// block reduces its threads and makes one atomicMin into an int32 set to
// BIG. Elements at/after the length read as zero, so a sequence cut at
// the length flags on the zero after it and the scan covers one word past
// the last in-range one.
#include "utf8.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int BIGI = 2147483647;

enum Mode { UTF8 = 0, ASCII = 1, UTF16LE = 2, UTF16BE = 3 };

// swar._hz / _eq: 0x80 bit per zero byte of the masked, xored word
__device__ __forceinline__ uint32_t hz(uint32_t v) {
  return (v - 0x01010101u) & ~v & 0x80808080u;
}
__device__ __forceinline__ uint32_t eq8(uint32_t b, uint32_t mask, uint32_t val) {
  return hz((b & (mask * 0x01010101u)) ^ (val * 0x01010101u));
}

// swar._hz16 / _eq16: the halfword analog
__device__ __forceinline__ uint32_t hz16(uint32_t v) {
  return (v - 0x00010001u) & ~v & 0x80008000u;
}
__device__ __forceinline__ uint32_t eq16(uint32_t w, uint32_t mask, uint32_t val) {
  return hz16((w & (mask * 0x00010001u)) ^ (val * 0x00010001u));
}

// swar._bswap16x2: both units of a word from BE to native order
__device__ __forceinline__ uint32_t bswap16x2(uint32_t w) {
  return ((w << 8) & 0xFF00FF00u) | ((w >> 8) & 0x00FF00FFu);
}

__device__ __forceinline__ uint32_t lead234(uint32_t x) {
  return eq8(x, 0xE0, 0xC0) | eq8(x, 0xF0, 0xE0) | eq8(x, 0xF8, 0xF0);
}

// swar._swar_body on one word b with its raw neighbours
__device__ __forceinline__ uint32_t utf8_err(uint32_t prev, uint32_t b,
                                             uint32_t next) {
  const uint32_t cont = eq8(b, 0xC0, 0x80);
  const uint32_t bm1 = (b << 8) | (prev >> 24);
  const uint32_t bm2 = (b << 16) | (prev >> 16);
  const uint32_t bm3 = (b << 24) | (prev >> 8);
  const uint32_t must = lead234(bm1) | (eq8(bm2, 0xF0, 0xE0) | eq8(bm2, 0xF8, 0xF0)) |
                        eq8(bm3, 0xF8, 0xF0);
  uint32_t err = must ^ cont;
  const uint32_t b1 = (b >> 8) | (next << 24);
  const uint32_t a_80_9f = eq8(b1, 0xE0, 0x80);
  const uint32_t a_a0_bf = eq8(b1, 0xE0, 0xA0);
  const uint32_t a_80_8f = eq8(b1, 0xF0, 0x80);
  err |= eq8(b, 0xFE, 0xC0);                            // C0/C1
  err |= eq8(b, 0xFF, 0xE0) & a_80_9f;                  // overlong 3-byte
  err |= eq8(b, 0xFF, 0xED) & a_a0_bf;                  // surrogate
  err |= eq8(b, 0xFF, 0xF0) & a_80_8f;                  // overlong 4-byte
  err |= eq8(b, 0xFF, 0xF4) & ~a_80_8f & 0x80808080u;   // too large
  err |= eq8(b, 0xFC, 0xF4) & ~eq8(b, 0xFF, 0xF4);      // F5..F7
  err |= eq8(b, 0xF8, 0xF8);                            // >= F8
  return err;
}

// swar._utf16_swar_body on one native-order word w with its neighbours
__device__ __forceinline__ uint32_t utf16_err(uint32_t prev, uint32_t w,
                                              uint32_t next) {
  const uint32_t high = eq16(w, 0xFC00, 0xD800);
  const uint32_t low = eq16(w, 0xFC00, 0xDC00);
  const uint32_t next_low = (low >> 16) | (eq16(next, 0xFC00, 0xDC00) << 16);
  const uint32_t prev_high = (high << 16) | (eq16(prev, 0xFC00, 0xD800) >> 16);
  return (high & ~next_low) | (low & ~prev_high);
}

template <int MODE>
__device__ __forceinline__ uint32_t flags(uint32_t prev, uint32_t cur,
                                          uint32_t next) {
  if constexpr (MODE == UTF8) return utf8_err(prev, cur, next);
  if constexpr (MODE == ASCII) return cur & 0x80808080u;
  if constexpr (MODE == UTF16BE)
    return utf16_err(bswap16x2(prev), bswap16x2(cur), bswap16x2(next));
  return utf16_err(prev, cur, next);
}

// word k of the buffer (4 bytes, or 2 units, little-endian), elements
// at/after ``length`` and words before the start read as zero
template <int MODE>
__device__ __forceinline__ uint32_t load_word(const void* base, long long k,
                                              long long length) {
  if (k < 0) return 0;
  uint32_t v = 0;
  if constexpr (MODE >= UTF16LE) {
    const uint16_t* u = static_cast<const uint16_t*>(base);
    const long long p = 2 * k;
    if (p < length) v = u[p];
    if (p + 1 < length) v |= (uint32_t)u[p + 1] << 16;
  } else {
    const uint8_t* b = static_cast<const uint8_t*>(base);
    const long long p = 4 * k;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p + j < length) v |= (uint32_t)b[p + j] << (8 * j);
  }
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    swar_kernel(const void* __restrict__ base, long long length,
                long long nwords, int* __restrict__ out) {
  __shared__ int s_min[NW];
  constexpr long long PER_WORD = MODE >= UTF16LE ? 2 : 4;  // elements a word
  const bool vec = (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  const uint32_t* words = static_cast<const uint32_t*>(base);
  const long long groups = (nwords + 3) / 4;
  int best = BIGI;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const long long k0 = 4 * g;
    uint32_t w[6];  // words k0-1 .. k0+4
    if (vec && k0 >= 1 && (k0 + 5) * PER_WORD <= length) {
      const uint4 m = *reinterpret_cast<const uint4*>(words + k0);
      w[0] = words[k0 - 1];
      w[1] = m.x;
      w[2] = m.y;
      w[3] = m.z;
      w[4] = m.w;
      w[5] = words[k0 + 4];
    } else {
#pragma unroll
      for (int i = 0; i < 6; ++i) w[i] = load_word<MODE>(base, k0 - 1 + i, length);
    }
    int found = -1;
#pragma unroll
    for (int i = 3; i >= 0; --i)
      if (k0 + i < nwords && flags<MODE>(w[i], w[i + 1], w[i + 2])) found = i;
    if (found >= 0) {
      best = (int)(k0 + found);
      break;  // later steps of this thread lie further on
    }
  }
  best = __reduce_min_sync(su::FULL, best);
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = s_min[0];
#pragma unroll
    for (int i = 1; i < NW; ++i) r = s_min[i] < r ? s_min[i] : r;
    if (r != BIGI) atomicMin(out, r);
  }
}

template <int MODE>
int launch(const void* base, long long length, long long nwords, int* out,
           void* stream) {
  swar_kernel<MODE><<<su::grid_for((nwords + 3) / 4), THREADS, 0,
                      (cudaStream_t)stream>>>(base, length, nwords, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out: one int32 on the device set to BIG; it gets the first flagged word
// index, or stays BIG. Returns cudaGetLastError().
//
// UTF-8: the words that can flag are those up to one past the last
// in-range byte's word (a cut sequence flags on the zero after it).
extern "C" int utf8_swar_first_bad_word(const uint8_t* b, long long length,
                                        int* out, void* stream) {
  return launch<UTF8>(b, length, (length + 3) / 4 + 1, out, stream);
}

extern "C" int ascii_swar_first_bad_word(const uint8_t* b, long long length,
                                         int* out, void* stream) {
  return launch<ASCII>(b, length, (length + 3) / 4, out, stream);
}

// w: uint16 units as stored (byte-swapped when be); length in units. A
// word flags only on a surrogate unit, so the in-range words suffice.
extern "C" int utf16_swar_first_bad_word(const uint16_t* w, long long length,
                                         int be, int* out, void* stream) {
  const long long nwords = (length + 1) / 2;
  return be ? launch<UTF16BE>(w, length, nwords, out, stream)
            : launch<UTF16LE>(w, length, nwords, out, stream);
}
