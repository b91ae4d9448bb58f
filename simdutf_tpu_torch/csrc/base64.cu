// Forgiving base64 on Hopper: whitespace compaction of the sextet code
// stream (b64_compact), the fixed-rate 4 -> 3 repack (b64_pack) and the
// fixed-rate 3 -> 4 encode (b64_encode); and the clean decode of
// whitespace-free input (clean_decode).
//
// b64_compact replaces the Pallas kernel _phase_b64_kernel
// (simdutf_tpu/kernels/butterfly64.py) together with the phase C16
// placement that composes its tiles (butterfly16._phase_c16_kernel), as two
// launches with the torch glue of ops/common.tile_glue between them.
// Count pass, one block per tile of 4096 chars: classify each in-range char
// with the range compares of ops/base64_ops.classify_chars (0..63 alphabet,
// 64 whitespace, 255 invalid; a char16 unit above 0xFF is invalid), and
// reduce the tile's kept (alphabet) count, its least invalid position as
// the key pos << 8 | 1, and the kept chars before that position. Emit
// pass, one block per tile: recompute the codes, block-scan the keep
// counts, stage the tile's codes in shared memory and write them as one
// contiguous run at the tile's exclusive offset; the thread that holds the
// kept char of rank nvalid & ~3 records its source index (tail_start). All
// alphabet chars are kept, those after the first invalid one too: the
// decoded buffer of the reference depends on them. The TPU compacts with
// 15 roll/select butterfly rounds per tile because its scatter serialised;
// a block scan gives each char its slot directly, and there is no
// candidate bound, so dense whitespace needs no fallback.
//
// b64_pack replaces _pack_kernel (base64_kernel.py, pack_sextets) and
// _pack_words_kernel (pack_words): both compute the same function on a
// flat stream of code bytes, 4 codes -> 3 bytes. b64_encode replaces
// _encode_kernel (block_encode): 3 bytes -> 4 alphabet chars, with the
// compares of _unclassify. One thread turns 16 codes (one 16-byte load)
// into 12 bytes, or 12 bytes into 16 chars (one 16-byte store).
//
// clean_decode replaces _decode_kernel (base64_kernel._clean_decode_pallas;
// core _decode_core, _classify, _mix_planes): each 4-char word -> 3 bytes,
// the chars classified by _classify's range compares (default, url or both
// alphabets; 255 for whitespace, '=' and garbage alike), a flag for any
// char outside the alphabet, and the words at/after nwords decoded as
// "AAAA" (zeros, no flag). The TPU builds each output word from stride-4
// phase planes to avoid lane gathers; here a thread decodes 4 words from
// one 16-byte load into three 4-byte stores. It reads 4 and writes 3 bytes
// a word.
//
// Floor: HBM bytes. Compaction reads the chars twice (count and emit pass)
// and writes the dense codes; the pack reads them once more and writes
// 3/4 as many bytes; encode reads n and writes 4n/3 bytes. Each char is a
// handful of integer compares, far below the card's integer rate.
#include "utf8.cuh"  // block reductions and scans, NO_EVENT, grid_for

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int PER = 16;                        // chars per thread
constexpr long long TILE = THREADS * PER;      // = kernels/compact64.TILE
constexpr int SKIP = 64;                       // whitespace, or out of range
constexpr int INVALID = 255;

__device__ __forceinline__ bool aligned(const void* p, int k) {
  return (reinterpret_cast<uintptr_t>(p) & (k - 1)) == 0;
}

// ops/base64_ops.classify_chars of one char value c in [0, 255]
__device__ __forceinline__ int classify(int c, bool url, bool both) {
  if (c >= 65 && c <= 90) return c - 65;   // A-Z
  if (c >= 97 && c <= 122) return c - 71;  // a-z
  if (c >= 48 && c <= 57) return c + 4;    // 0-9
  if (both || !url) {
    if (c == 43) return 62;  // '+'
    if (c == 47) return 63;  // '/'
  }
  if (both || url) {
    if (c == 45) return 62;  // '-'
    if (c == 95) return 63;  // '_'
  }
  if (c == 32 || c == 9 || c == 10 || c == 13 || c == 12) return SKIP;
  return INVALID;
}

// code[j] of the char at p0 + j, j in [0, PER): its class, or SKIP at and
// after ``length``. p0 is a multiple of PER; whole in-range chunks of an
// aligned buffer take 16-byte loads.
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ c,
                                           long long p0, long long length,
                                           bool url, bool both, int* code) {
  int v[PER];
  if (p0 + PER <= length && aligned(c, 16)) {
    const uint4 m = *reinterpret_cast<const uint4*>(c + p0);
    const uint32_t x[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = (x[j >> 2] >> (8 * (j & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = p0 + j < length ? c[p0 + j] : -1;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) code[j] = v[j] < 0 ? SKIP : classify(v[j], url, both);
}

__device__ __forceinline__ void load_codes(const uint16_t* __restrict__ c,
                                           long long p0, long long length,
                                           bool url, bool both, int* code) {
  int v[PER];
  if (p0 + PER <= length && aligned(c, 16)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 m = *reinterpret_cast<const uint4*>(c + p0 + 8 * h);
      const uint32_t x[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[8 * h + 2 * k] = x[k] & 0xFFFF;
        v[8 * h + 2 * k + 1] = x[k] >> 16;
      }
    }
  } else {  // unit loads: also for views that are not 16-byte aligned
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = p0 + j < length ? c[p0 + j] : -1;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    code[j] = v[j] < 0 ? SKIP : v[j] > 0xFF ? INVALID : classify(v[j], url, both);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    count_kernel(const T* __restrict__ c, long long length, int url, int both,
                 int* __restrict__ counts, unsigned long long* __restrict__ keys,
                 int* __restrict__ prefix) {
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_sum[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * PER;
  int code[PER];
  load_codes(c, p0, length, url, both, code);
  int cnt = 0;
  unsigned long long key = su::NO_EVENT;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    cnt += code[j] <= 63;
    if (key == su::NO_EVENT && code[j] == INVALID)
      key = ((unsigned long long)(p0 + j) << 8) | 1;
  }
  key = su::block_min_u64<NW>(key, s_key);
  const int tile_cnt = su::block_sum<NW>(cnt, s_sum);
  // kept chars of this thread strictly before the tile's first invalid one
  const long long epos = (long long)(key >> 8);
  int pre = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) pre += code[j] <= 63 && p0 + j < epos;
  const int tile_pre = su::block_sum<NW>(pre, s_sum);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = tile_cnt;
    keys[blockIdx.x] = key;
    prefix[blockIdx.x] = tile_pre;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    emit_kernel(const T* __restrict__ c, long long length, int url, int both,
                const long long* __restrict__ off,
                const long long* __restrict__ nvalid,
                uint8_t* __restrict__ out, long long* __restrict__ tail_start) {
  __shared__ uint8_t s_codes[TILE];
  __shared__ int s_scan[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * PER;
  int code[PER];
  load_codes(c, p0, length, url, both, code);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) cnt += code[j] <= 63;
  int tile_cnt;
  int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_cnt);
  const long long base = off[blockIdx.x];
  const long long nv = *nvalid;
  const long long nfull = nv & ~3ll;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (code[j] > 63) continue;
    s_codes[slot] = (uint8_t)code[j];
    if (nv > nfull && base + slot == nfull) *tail_start = p0 + j;
    ++slot;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile_cnt; i += THREADS) out[base + i] = s_codes[i];
}

// 4 code bytes (one little-endian word) -> their 3 decoded bytes in the
// low 24 bits, in stream order (base64_kernel._pack_core on any bytes)
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  const uint32_t t = ((w & 0xFF) << 18) | (((w >> 8) & 0xFF) << 12) |
                     (((w >> 16) & 0xFF) << 6) | (w >> 24);
  return ((t >> 16) & 0xFF) | (t & 0xFF00) | ((t & 0xFF) << 16);
}

__global__ void __launch_bounds__(THREADS)
    pack_kernel(const uint8_t* __restrict__ codes, long long groups,
                uint8_t* __restrict__ out) {
  const long long chunks = (groups + 3) / 4;  // 16 codes each
  const bool vec = aligned(codes, 16) && aligned(out, 4);
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    if (vec && 4 * k + 4 <= groups) {
      const uint4 m = *reinterpret_cast<const uint4*>(codes + 16 * k);
      const uint32_t a = pack4(m.x), b = pack4(m.y), c = pack4(m.z),
                     d = pack4(m.w);
      uint32_t* o = reinterpret_cast<uint32_t*>(out + 12 * k);
      o[0] = a | (b << 24);
      o[1] = (b >> 8) | (c << 16);
      o[2] = (c >> 16) | (d << 8);
    } else {
      for (long long g = 4 * k; g < 4 * k + 4 && g < groups; ++g) {
        const uint8_t* s = codes + 4 * g;
        const uint32_t y = pack4(s[0] | (s[1] << 8) | (s[2] << 16) |
                                 ((uint32_t)s[3] << 24));
        out[3 * g] = y & 0xFF;
        out[3 * g + 1] = (y >> 8) & 0xFF;
        out[3 * g + 2] = y >> 16;
      }
    }
  }
}

// 4 chars (one little-endian word) -> 4 value bytes of _classify: the
// alphabet value, 255 for anything else (whitespace and '=' too); the
// word's chars are all in the alphabet when no byte exceeds 63
__device__ __forceinline__ uint32_t classify4(uint32_t w, bool url, bool both) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = classify((w >> (8 * i)) & 0xFF, url, both);
    v |= (uint32_t)(c == SKIP ? INVALID : c) << (8 * i);
  }
  return v;
}

// One thread per 4 char words (one 16-byte load, three 4-byte stores of
// 12 output bytes); words at/after nwords read as "AAAA" (zeros out, no
// flag); one atomicOr per block that saw a char outside the alphabet.
__global__ void __launch_bounds__(THREADS)
    clean_decode_kernel(const uint8_t* __restrict__ chars, long long words,
                        long long nwords, int url, int both,
                        uint8_t* __restrict__ out, int* __restrict__ flag) {
  const long long chunks = (words + 3) / 4;
  const bool vec = aligned(chars, 16) && aligned(out, 4);
  int bad = 0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    uint32_t w[4];
    if (vec && 4 * k + 4 <= words) {
      const uint4 m = *reinterpret_cast<const uint4*>(chars + 16 * k);
      w[0] = m.x;
      w[1] = m.y;
      w[2] = m.z;
      w[3] = m.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long g = 4 * k + i;
        w[i] = g < words ? chars[4 * g] | (chars[4 * g + 1] << 8) |
                               (chars[4 * g + 2] << 16) |
                               ((uint32_t)chars[4 * g + 3] << 24)
                         : 0x41414141u;
      }
    }
    uint32_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = classify4(4 * k + i < nwords ? w[i] : 0x41414141u,
                                   url, both);
      bad |= (v & 0xC0C0C0C0u) != 0;  // some value > 63
      y[i] = pack4(v);
    }
    if (vec && 4 * k + 4 <= words) {
      uint32_t* o = reinterpret_cast<uint32_t*>(out + 12 * k);
      o[0] = y[0] | (y[1] << 24);
      o[1] = (y[1] >> 8) | (y[2] << 16);
      o[2] = (y[2] >> 16) | (y[3] << 8);
    } else {
      for (long long g = 4 * k; g < 4 * k + 4 && g < words; ++g) {
        const uint32_t q = y[g - 4 * k];
        out[3 * g] = q & 0xFF;
        out[3 * g + 1] = (q >> 8) & 0xFF;
        out[3 * g + 2] = q >> 16;
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// base64_kernel._unclassify: a 6-bit value -> its alphabet char
__device__ __forceinline__ uint32_t unclassify(uint32_t v, bool url) {
  uint32_t c = v + 65;
  if (v >= 26) c = v + 71;
  if (v >= 52) c = v - 4;
  if (v == 62) c = url ? 45 : 43;
  if (v == 63) c = url ? 95 : 47;
  return c;
}

// 3 bytes (stream order) -> 4 chars as one little-endian word
__device__ __forceinline__ uint32_t encode3(uint32_t b0, uint32_t b1,
                                           uint32_t b2, bool url) {
  const uint32_t t = (b0 << 16) | (b1 << 8) | b2;
  return unclassify(t >> 18, url) | (unclassify((t >> 12) & 63, url) << 8) |
         (unclassify((t >> 6) & 63, url) << 16) |
         (unclassify(t & 63, url) << 24);
}

__global__ void __launch_bounds__(THREADS)
    encode_kernel(const uint8_t* __restrict__ data, long long triples, int url,
                  uint8_t* __restrict__ out) {
  const long long chunks = (triples + 3) / 4;  // 12 bytes each
  const bool vec = aligned(data, 4) && aligned(out, 16);
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    if (vec && 4 * k + 4 <= triples) {
      const uint32_t* s = reinterpret_cast<const uint32_t*>(data + 12 * k);
      const uint32_t w0 = s[0], w1 = s[1], w2 = s[2];
      uint4 m;
      m.x = encode3(w0 & 0xFF, (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF, url);
      m.y = encode3(w0 >> 24, w1 & 0xFF, (w1 >> 8) & 0xFF, url);
      m.z = encode3((w1 >> 16) & 0xFF, w1 >> 24, w2 & 0xFF, url);
      m.w = encode3((w2 >> 8) & 0xFF, (w2 >> 16) & 0xFF, w2 >> 24, url);
      *reinterpret_cast<uint4*>(out + 16 * k) = m;
    } else {
      for (long long g = 4 * k; g < 4 * k + 4 && g < triples; ++g) {
        const uint8_t* s = data + 3 * g;
        const uint32_t q = encode3(s[0], s[1], s[2], url);
#pragma unroll
        for (int i = 0; i < 4; ++i) out[4 * g + i] = (q >> (8 * i)) & 0xFF;
      }
    }
  }
}

template <typename T>
int compact_count(const T* c, long long length, int url, int both, int nt,
                  int* counts, unsigned long long* keys, int* prefix,
                  void* stream) {
  count_kernel<T><<<nt, THREADS, 0, (cudaStream_t)stream>>>(
      c, length, url, both, counts, keys, prefix);
  return (int)cudaGetLastError();
}

template <typename T>
int compact_emit(const T* c, long long length, int url, int both, int nt,
                 const long long* off, const long long* nvalid, uint8_t* out,
                 long long* tail_start, void* stream) {
  emit_kernel<T><<<nt, THREADS, 0, (cudaStream_t)stream>>>(
      c, length, url, both, off, nvalid, out, tail_start);
  return (int)cudaGetLastError();
}

}  // namespace

// Count pass over nt = ceil(length / TILE) tiles of uint8 (b64_compact8_*)
// or uint16 (b64_compact16_*) chars: per tile the kept count, the least
// invalid key (BIG << 8 when none) and the kept chars before it. Returns
// cudaGetLastError().
extern "C" int b64_compact8_count(const uint8_t* c, long long length, int url,
                                  int both, int nt, int* counts,
                                  unsigned long long* keys, int* prefix,
                                  void* stream) {
  return compact_count(c, length, url, both, nt, counts, keys, prefix, stream);
}

extern "C" int b64_compact16_count(const uint16_t* c, long long length,
                                   int url, int both, int nt, int* counts,
                                   unsigned long long* keys, int* prefix,
                                   void* stream) {
  return compact_count(c, length, url, both, nt, counts, keys, prefix, stream);
}

// Emit pass: tile t's codes go to out[off[t] + i]; *tail_start gets the
// source index of the kept char of rank *nvalid & ~3 when *nvalid is not a
// multiple of 4 (the caller sets it to length first). The rest of ``out``
// is left as the caller zeroed it.
extern "C" int b64_compact8_emit(const uint8_t* c, long long length, int url,
                                 int both, int nt, const long long* off,
                                 const long long* nvalid, uint8_t* out,
                                 long long* tail_start, void* stream) {
  return compact_emit(c, length, url, both, nt, off, nvalid, out, tail_start,
                      stream);
}

extern "C" int b64_compact16_emit(const uint16_t* c, long long length, int url,
                                  int both, int nt, const long long* off,
                                  const long long* nvalid, uint8_t* out,
                                  long long* tail_start, void* stream) {
  return compact_emit(c, length, url, both, nt, off, nvalid, out, tail_start,
                      stream);
}

// out[3g .. 3g+2] = the 3 bytes of codes[4g .. 4g+3], g < groups.
extern "C" int b64_pack(const uint8_t* codes, long long groups, uint8_t* out,
                        void* stream) {
  pack_kernel<<<su::grid_for((groups + 3) / 4), THREADS, 0,
                (cudaStream_t)stream>>>(codes, groups, out);
  return (int)cudaGetLastError();
}

// Clean decode of ``nwords`` whole 4-char words of ``chars`` (``words`` =
// its size / 4 >= nwords): out gets 3 bytes a word, zeros from word
// nwords on; flag, one zeroed int32 on the device, becomes 1 when an
// in-range char is outside the alphabet. Returns cudaGetLastError().
extern "C" int clean_decode(const uint8_t* chars, long long words,
                            long long nwords, int url, int both, uint8_t* out,
                            int* flag, void* stream) {
  clean_decode_kernel<<<su::grid_for((words + 3) / 4), THREADS, 0,
                        (cudaStream_t)stream>>>(chars, words, nwords, url, both,
                                                out, flag);
  return (int)cudaGetLastError();
}

// out[4g .. 4g+3] = the 4 chars of data[3g .. 3g+2], g < triples.
extern "C" int b64_encode(const uint8_t* data, long long triples, int url,
                          uint8_t* out, void* stream) {
  encode_kernel<<<su::grid_for((triples + 3) / 4), THREADS, 0,
                  (cudaStream_t)stream>>>(data, triples, url, out);
  return (int)cudaGetLastError();
}
