// Forgiving base64 on Hopper: whitespace compaction of the sextet code
// stream (b64_compact), the fixed-rate 4 -> 3 repack (b64_pack) and the
// fixed-rate 3 -> 4 encode (b64_encode); and the clean decode of
// whitespace-free input (clean_decode).
//
// b64_compact replaces the Pallas kernel _phase_b64_kernel
// (simdutf_tpu/kernels/butterfly64.py) together with the phase C16
// placement that composes its tiles (butterfly16._phase_c16_kernel), as one
// launch per char width with a decoupled look-back scan across tiles
// (compact_kernel below, lookback.cuh): each char is read and classified
// once (0..63 alphabet, 64 whitespace, 255 invalid; a char16 unit above
// 0xFF is invalid), and the kernel also writes the zeros past nvalid and
// the four scalars. All alphabet chars are kept, those after the first
// invalid one too: the decoded buffer of the reference depends on them.
// The TPU compacts with 15 roll/select butterfly rounds per tile because
// its scatter serialised; a block scan gives each char its slot directly,
// and there is no candidate bound, so dense whitespace needs no fallback.
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
// Floor: HBM bytes. Compaction reads the chars once and writes the whole
// code buffer once; the pack reads them once more and writes
// 3/4 as many bytes; encode reads n and writes 4n/3 bytes. Pack and
// encode are a handful of integer operations a char; the compaction stays
// above its floor, held back by its look-back wait and per-char staging
// (PERF.md).
#include "lookback.cuh"  // the look-back scan; utf8.cuh's reductions, grid_for

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int PER = 64;                        // chars per thread
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

// Codes of the 16 chars at s (a multiple of 16), four to a word: the
// table's class of each char (a char16 unit above 0xFF is INVALID), SKIP at
// and after `length`. 16-byte loads where the chunk is in range and the
// buffer 16-byte aligned, element loads otherwise (also for views off the
// 16-byte grid).
__device__ __forceinline__ void codes16(const uint8_t* __restrict__ c, long long s,
                                        long long length, const uint8_t* table,
                                        uint32_t* cw) {
  uint32_t v[4];
  if (s + 16 <= length && aligned(c, 16)) {
    const uint4 m = *reinterpret_cast<const uint4*>(c + s);
    v[0] = m.x;
    v[1] = m.y;
    v[2] = m.z;
    v[3] = m.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long p = s + 4 * k + i;
        x |= (uint32_t)(p < length ? c[p] : ' ') << (8 * i);
      }
      v[k] = x;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) word |= (uint32_t)table[(v[k] >> (8 * i)) & 0xFF] << (8 * i);
    cw[k] = word;
  }
}

__device__ __forceinline__ void codes16(const uint16_t* __restrict__ c, long long s,
                                        long long length, const uint8_t* table,
                                        uint32_t* cw) {
  uint32_t v[8];
  if (s + 16 <= length && aligned(c, 16)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 m = *reinterpret_cast<const uint4*>(c + s + 8 * h);
      v[4 * h] = m.x;
      v[4 * h + 1] = m.y;
      v[4 * h + 2] = m.z;
      v[4 * h + 3] = m.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long p = s + 2 * k;
      v[k] = (p < length ? c[p] : ' ') | (uint32_t)(p + 1 < length ? c[p + 1] : ' ') << 16;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = (v[(4 * k + i) >> 1] >> (16 * (i & 1))) & 0xFFFF;
      word |= (uint32_t)(u > 0xFF ? INVALID : table[u]) << (8 * i);
    }
    cw[k] = word;
  }
}

// b64_compact: one launch, persistent grid, 16384-char tiles (256 threads
// x 64 chars) in the order of the look-back counter (lookback.cuh). A tile
// classifies each char once through a 256-entry shared table (0..63
// alphabet, SKIP whitespace and positions past `length`, INVALID),
// block-scans the kept counts, stages its codes in shared memory,
// publishes (kept, least invalid key pos << 8 | 1, kept before it) and the
// source indices of its last three kept chars, looks back for its offset
// and stores the staged codes as aligned 16-byte chunks there. The last
// tile writes nvalid, first_bad, nvalid_at_bad and tail_start; tail_start
// needs nvalid, so that tile walks back over the published counts to the
// tile holding the kept char of rank nvalid & ~3 (far back when the last
// tiles are whitespace) and reads its index there. Then every block zeroes
// its share of codes[nvalid, n).
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
    compact_kernel(const T* __restrict__ c, long long n, long long length,
                   int url, int both, int nt, su::Lookback lb,
                   uint8_t* __restrict__ out, long long* __restrict__ res) {
  __shared__ alignas(16) uint8_t s_codes[TILE + 16];  // (a word read past the last code)
  __shared__ uint8_t s_table[256];
  __shared__ int s_scan[NW];
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_last[3];
  __shared__ int s_tile;
  __shared__ su::Triple s_excl;
  for (int k = threadIdx.x; k < 256; k += THREADS)
    s_table[k] = (uint8_t)classify(k, url != 0, both != 0);
  const bool vec_out = aligned(out, 16);
  const int tid = threadIdx.x;

  for (;;) {
    if (tid == 0) s_last[0] = s_last[1] = s_last[2] = -1;
    const int t = su::claim_tile(lb, &s_tile);  // its barrier also covers the table
    if (t >= nt) break;
    const long long s = (long long)t * TILE + (long long)tid * PER;

    // classify once; codes packed four to a word
    uint32_t cw[PER / 4];
#pragma unroll
    for (int g = 0; g < PER / 16; ++g) codes16(c, s + 16 * g, length, s_table, cw + 4 * g);
    // kept (alphabet) codes and INVALID ones, as bit 7 of each byte
    uint32_t kw[PER / 4];
    int cnt = 0, first = PER;
#pragma unroll
    for (int k = PER / 4 - 1; k >= 0; --k) {
      kw[k] = ~(cw[k] | (cw[k] << 1)) & 0x80808080u;  // bits 7 and 6 clear
      cnt += __popc(kw[k]);
      const uint32_t bad = cw[k] & (cw[k] << 1) & 0x80808080u;  // 0xC0 and up
      if (bad) first = 4 * k + ((__ffs(bad) - 1) >> 3);
    }
    int tile_cnt;
    int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_cnt);
    su::Triple own = su::triple(tile_cnt, tile_cnt, su::NO_EVENT);
    if (__syncthreads_or(first < PER)) {
      unsigned long long key =
          first < PER ? ((unsigned long long)(s + first) << 8) | 1 : su::NO_EVENT;
      key = su::block_min_u64<NW>(key, s_key);
      const long long epos = (long long)(key >> 8);
      int pre = 0;
#pragma unroll
      for (int k = 0; k < PER / 4; ++k) {
        const long long d = epos - (s + 4 * k);  // kept chars of word k before epos
        pre += __popc(kw[k] & (d >= 4 ? 0xFFFFFFFFu : d <= 0 ? 0u : (1u << (8 * d)) - 1u));
      }
      pre = su::block_sum<NW>(pre, s_scan);
      own = su::triple(tile_cnt, pre, key);
    }
    // the source indices of the tile's last three kept chars
    if (cnt > 0 && slot + cnt > tile_cnt - 3) {
      int r = slot + cnt - 1;  // rank of the thread's last kept char
#pragma unroll
      for (int j = PER - 1; j >= 0; --j) {
        if (kw[j >> 2] >> (8 * (j & 3) + 7) & 1) {
          if (r >= tile_cnt - 3) s_last[tile_cnt - 1 - r] = (int)(s + j);
          --r;
        }
      }
    }
    // stage the kept codes in order
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (kw[j >> 2] >> (8 * (j & 3) + 7) & 1)
        s_codes[slot++] = (uint8_t)(cw[j >> 2] >> (8 * (j & 3)));
    __syncthreads();

    // publish, look back, publish the inclusive value
    if (tid < 32) {
      if (tid == 0) {
        int* x = reinterpret_cast<int*>(lb.extra + t);
        su::st_relaxed(x, s_last[0]);
        su::st_relaxed(x + 1, s_last[1]);
        su::st_relaxed(x + 2, s_last[2]);
        __threadfence();
        su::publish_aggregate(lb, t, own);
      }
      const su::Triple excl =
          t > 0 ? su::lookback_prefix(lb, t) : su::triple(0, 0, su::NO_EVENT);
      const su::Triple inc = su::combine(excl, own);
      if (tid == 0) {
        if (t > 0) su::publish_inclusive(lb, t, inc);
        s_excl = excl;
      }
      if (t == nt - 1) {
        const int lane = tid;
        long long tail = length;
        int k = inc.count & 3;
        if (k) {  // the k-th kept char from the end has rank nvalid & ~3
          for (int j = t;; j -= 32) {
            const int i = j - lane;
            const int tc = i >= 0 ? su::wait_slot(lb.agg + i).count : 0;
            int inc_c = tc;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const int y = __shfl_up_sync(su::FULL, inc_c, d);
              if (lane >= d) inc_c += y;
            }
            const unsigned hit = __ballot_sync(su::FULL, inc_c >= k);
            if (hit) {
              const int src = __ffs(hit) - 1;
              int idx = 0;
              if (lane == src) {
                __threadfence();
                idx = su::ld_relaxed(reinterpret_cast<const int*>(lb.extra + i) +
                                     (k - (inc_c - tc) - 1));
              }
              tail = __shfl_sync(su::FULL, idx, src);
              break;
            }
            k -= __shfl_sync(su::FULL, inc_c, 31);
          }
        }
        if (lane == 0) {
          const bool bad = inc.key != su::NO_EVENT;
          res[0] = inc.count;
          res[1] = (long long)(inc.key >> 8);
          res[2] = bad ? inc.before : 0;
          res[3] = tail;
        }
      }
    }
    __syncthreads();
    if (tile_cnt == 0) continue;

    // store codes [0, tile_cnt) at out[base ..] as aligned 16-byte chunks
    const long long base = s_excl.count;
    const int sh = (int)(base & 15);
    uint8_t* dst = out + (base - sh);
    const int end = sh + tile_cnt;
    for (int q = tid; q * 16 < end; q += THREADS) {
      const int u0 = q * 16 - sh;  // shared index of the chunk's first code
      if (vec_out && u0 >= 0 && u0 + 16 <= tile_cnt) {
        // five aligned words of s_codes, shifted by the chunk's byte phase
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(s_codes) + (u0 >> 2);
        const int ph = 8 * (u0 & 3);
        uint32_t w[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) w[i] = sw[i];
        __stcs(reinterpret_cast<uint4*>(dst + q * 16),
               make_uint4(__funnelshift_r(w[0], w[1], ph), __funnelshift_r(w[1], w[2], ph),
                          __funnelshift_r(w[2], w[3], ph), __funnelshift_r(w[3], w[4], ph)));
      } else {
        for (int i = u0 < 0 ? 0 : u0; i < u0 + 16 && i < tile_cnt; ++i) out[base + i] = s_codes[i];
      }
    }
  }

  // the zero tail past nvalid
  const su::Triple last = su::block_wait_inclusive(lb, nt - 1, &s_excl);
  su::zero_share(out, last.count, n, blockIdx.x, gridDim.x);
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
int compact(const T* c, long long n, long long length, int url, int both,
            int nt, void* scratch, uint8_t* out, long long* res, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = su::lookback_reset(scratch, nt, st);
  if (rc != 0) return rc;
  static int cap = 0;
  if (cap == 0) cap = su::resident_blocks(compact_kernel<T>, THREADS);
  const long long want = nt > (n + 65535) / 65536 ? nt : (n + 65535) / 65536;
  const int grid = want < cap ? (int)want : cap;
  compact_kernel<T><<<grid, THREADS, 0, st>>>(
      c, n, length, url, both, nt, su::lookback_carve(scratch, nt), out, res);
  return (int)cudaGetLastError();
}

}  // namespace

// Compaction of chars[:length] (uint8: b64_compact8, uint16 char16:
// b64_compact16) in one launch over nt = ceil(length / TILE) >= 1 tiles:
// out (uint8[n]) gets the code of every alphabet char in order, zero from
// nvalid on; res (int64[4]) = nvalid, first_bad (BIG when none),
// nvalid_at_bad (0 when none), tail_start (the source index of the kept
// char of rank nvalid & ~3, or length when nvalid is a multiple of 4).
// `scratch` holds 16 + 48 nt bytes (lookback.cuh); its head is cleared here on
// `stream` first. Returns cudaGetLastError().
extern "C" int b64_compact8(const uint8_t* c, long long n, long long length,
                            int url, int both, int nt, void* scratch,
                            uint8_t* out, long long* res, void* stream) {
  return compact(c, n, length, url, both, nt, scratch, out, res, stream);
}

extern "C" int b64_compact16(const uint16_t* c, long long n, long long length,
                             int url, int both, int nt, void* scratch,
                             uint8_t* out, long long* res, void* stream) {
  return compact(c, n, length, url, both, nt, scratch, out, res, stream);
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
