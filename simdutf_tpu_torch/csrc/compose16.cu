// utf8_to_utf16_compose: the general (mixed-script) validating UTF-8 ->
// UTF-16LE/BE transcode in one launch (replaces the Pallas kernels
// _phase_b_kernel and _phase_c_kernel behind
// simdutf_tpu/kernels/butterfly.to_utf16_compose).
//
// A persistent grid walks 16 KiB tiles (256 threads x 64 bytes) in the
// order of a global tile counter (lookback.cuh). For each tile a block:
//  1. reads its bytes once: 64 a thread in four 16-byte loads, with 8 bytes
//     of halo before and 4 after;
//  2. marks the bytes that carry a unit (an in-range lead, or the byte
//     after a 4-byte lead, which may sit at `length` itself) and counts
//     them, four bytes at a time on 32-bit words;
//  3. runs a fast check that may flag valid text but never misses an event
//     of the error lattice: a structural test (every byte a lead asks for
//     is a continuation and no other byte is) and the value tests of
//     simdutf's lookup tables (C0/C1, E0 and ED, F0 and F4-F7 against the
//     next byte, F8-FF), as bit masks on the words. Only a tile the check
//     flags computes the exact key of utf8.cuh's event_key lattice and the
//     units before it, in the same launch; valid text does no 64-bit min;
//  4. stages its bytes and the offsets of its kept bytes in shared memory
//     and publishes (units, least key, units before it);
//  5. while warp 0 looks back for the exclusive prefix (the output offset,
//     and whether the first error lies before the tile), the other warps
//     decode each kept byte's unit once, branch-free (the high surrogate at
//     a 4-byte lead, the low at the byte after it), in place of its offset;
//  6. stores the units as aligned 16-byte chunks at the offset. With the
//     clamp, a tile after the first error writes nothing and the error
//     tile stops at the units before it; without it every in-range lead
//     writes its unit(s), past the error too.
// Once the tiles are spent, each block waits for the last tile's inclusive
// value and zeroes its share of the output past out_len, so the wrapper
// needs no fill. The last tile writes total, err_pos, err_code, err_len
// and err_any.
//
// Floor: HBM bytes, one read of the input and one write of the whole
// uint16 output. This kernel stays above it, bound by integer instructions
// a byte (the check, the decode, the staging; about 60 a byte, PERF.md);
// the word-wise masks and the per-unit decode keep that count down.
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int PER = 64;                    // bytes a thread
constexpr int WORDS = PER / 4;             // 16
constexpr int TILE = THREADS * PER;        // = kernels/compose16.TILE
constexpr uint32_t H = 0x80808080u;

// window word k holds bytes s - 8 + 4k .. s - 5 + 4k of thread start s:
// words 0-1 the halo before, 2..WORDS+1 the thread's own, WORDS+2 after
constexpr int NWIN = WORDS + 3;

// bit 7 of each byte set where that byte lies below `lim`, of the word of
// bytes q0 .. q0 + 3
__device__ __forceinline__ uint32_t below(long long q0, long long lim) {
  const long long k = lim - q0;
  return k >= 4 ? H : k <= 0 ? 0u : H & ((1u << (8 * k)) - 1u);
}

// byte classes of a word, as bit 7 of each byte
struct Classes {
  uint32_t cont, lead, l3, l4, l5;
};

__device__ __forceinline__ Classes classes(uint32_t w) {
  Classes c;
  const uint32_t hi = w & H;
  c.cont = hi & ~(w << 1);          // 10xxxxxx
  c.lead = hi & (w << 1);           // 11xxxxxx
  c.l3 = c.lead & (w << 2);         // >= E0
  c.l4 = c.l3 & (w << 3);           // >= F0
  c.l5 = c.l4 & (w << 4);           // >= F8: never valid
  return c;
}

// leads whose next byte decides an error: E0 (next < A0 is overlong), ED
// (next >= A0 a surrogate), F0 (next < 90 overlong), F4 (next >= 90 too
// large)
struct Special {
  uint32_t e0, ed, f0, f4;
};

__device__ __forceinline__ Special special(uint32_t w, const Classes& c) {
  const uint32_t lo = w & 0x0F0F0F0Fu;
  const uint32_t zero = ~(lo + 0x7F7F7F7Fu) & H;                 // low nibble 0
  const uint32_t is_d = ~((lo ^ 0x0D0D0D0Du) + 0x7F7F7F7Fu) & H;  // low nibble D
  const uint32_t is_4 = ~((lo ^ 0x04040404u) + 0x7F7F7F7Fu) & H;  // low nibble 4
  const uint32_t l3x = c.l3 & ~c.l4, l4x = c.l4 & ~c.l5;
  Special s;
  s.e0 = l3x & zero;
  s.ed = l3x & is_d;
  s.f0 = l4x & zero;
  s.f4 = l4x & is_4;
  return s;
}

__device__ __forceinline__ uint32_t fwd(uint32_t prev, uint32_t cur, int bytes) {
  return __funnelshift_l(prev, cur, 8 * bytes);
}

// Bytes of word w (classes c, s; the previous word's cp, sp) where the fast check flags. Every
// event of the lattice at a byte of a tile shows as a flag at that byte,
// at up to three bytes after it, or (an orphan continuation after an
// F8-FF byte) as the F8-FF byte up to three bytes before it.
__device__ __forceinline__ uint32_t check_word(uint32_t w, const Classes& c,
                                               const Special& s,
                                               const Classes& cp,
                                               const Special& sp) {
  const uint32_t need = fwd(cp.lead, c.lead, 1) | fwd(cp.l3, c.l3, 2) |
                        fwd(cp.l4, c.l4, 3);
  uint32_t err = (need ^ c.cont) | c.l5;
  // C0 and C1: a 2-byte lead with bits 4..1 clear is always an error
  err |= c.lead & ~c.l3 & ~((w & 0x1E1E1E1Eu) + 0x7F7F7F7Fu) & H;
  // F5-F7: too large whatever follows
  err |= c.l4 & ~c.l5 & ((w & 0x07070707u) + 0x7B7B7B7Bu) & H;
  const uint32_t b5 = (w << 2) & H;                             // bit 5 set
  const uint32_t b54 = ((w & 0x30303030u) + 0x7F7F7F7Fu) & H;   // bit 5 or 4
  err |= (fwd(sp.e0, s.e0, 1) & ~b5) | (fwd(sp.ed, s.ed, 1) & b5) |
         (fwd(sp.f0, s.f0, 1) & ~b54) | (fwd(sp.f4, s.f4, 1) & b54);
  return err;
}

// The unit of the kept byte at tile offset r (s_w holds the tile's bytes
// from its start, zero past `length`, and 4 bytes after its end; `a4` says
// the byte before r is a 4-byte lead). Branch-free: the lead's payload and
// three continuations' six bits make t; the sequence length (the lead's
// leading ones) says how much of t is the code point, as
// su::decode_cp's per-length formulas do (0 for F8-FF); a code point above
// 0xFFFF gives its high surrogate, and the byte after a 4-byte lead its
// low surrogate.
template <bool BE>
__device__ __forceinline__ uint32_t unit_of(const uint32_t* s_w, int r, bool a4) {
  const uint32_t X = __funnelshift_r(s_w[r >> 2], s_w[(r >> 2) + 1], 8 * (r & 3));
  const int k = __clz(~(X << 24));  // leading ones of the byte at r
  const uint32_t t = ((X & (0x7Fu >> k)) << 18) | ((X >> 8 & 0x3F) << 12) |
                     ((X >> 16 & 0x3F) << 6) | (X >> 24 & 0x3F);
  const uint32_t cp = k > 4 ? 0u : t >> (24 - 6 * (k > 1 ? k : 1));
  uint32_t v = cp > 0xFFFF ? 0xD7C0 + (cp >> 10) : cp;
  if (a4) v = 0xDC00 | ((X & 0x0F00) >> 2) | (X >> 16 & 0x3F);
  if (BE) v = ((v << 8) | (v >> 8)) & 0xFFFF;
  return v;
}

// shared memory of a block: the tile's bytes (with 16 before and after),
// then one uint16 a kept byte (its offset, bit 15 when it follows a 4-byte
// lead), each replaced in place by its unit
constexpr int LEAD = 16;  // staged bytes before the tile (8 used), keeping s_w aligned
constexpr int SMEM_BYTES = LEAD + TILE + 16;
constexpr int SMEM = SMEM_BYTES + 2 * TILE + 16;  // (a word read past the last unit)

template <bool BE>
__global__ void __launch_bounds__(THREADS, 4)
    compose16_kernel(const uint8_t* __restrict__ b, long long n,
                     long long length, int nt, int clamp, su::Lookback lb,
                     uint16_t* __restrict__ out, long long* __restrict__ res,
                     uint8_t* __restrict__ err_any) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* s_b = smem + LEAD;  // s_b[r]: the byte at tile offset r, r >= -8
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem + LEAD);
  uint16_t* s_u = reinterpret_cast<uint16_t*>(smem + SMEM_BYTES);
  __shared__ int s_scan[NW];
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_tile;
  __shared__ su::Triple s_excl;
  const bool vec_in = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int tid = threadIdx.x;

  for (;;) {
    const int t = su::claim_tile(lb, &s_tile);
    if (t >= nt) break;
    const long long s = (long long)t * TILE + (long long)tid * PER;

    // 1. the window
    uint32_t w[NWIN];
    const bool full = vec_in && s >= 8 && s + PER + 4 <= length;
    if (full) {
      const uint2 h = *reinterpret_cast<const uint2*>(b + s - 8);
      w[0] = h.x;
      w[1] = h.y;
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k) {
        const uint4 m = *reinterpret_cast<const uint4*>(b + s + 16 * k);
        w[2 + 4 * k] = m.x;
        w[3 + 4 * k] = m.y;
        w[4 + 4 * k] = m.z;
        w[5 + 4 * k] = m.w;
      }
      w[NWIN - 1] = *reinterpret_cast<const uint32_t*>(b + s + PER);
    } else {
#pragma unroll
      for (int k = 0; k < NWIN; ++k) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long q = s - 8 + 4 * k + j;
          if (q >= 0 && q < length) v |= (uint32_t)b[q] << (8 * j);
        }
        w[k] = v;
      }
    }
    // the tile's bytes for the decode
#pragma unroll
    for (int k = 0; k < WORDS / 4; ++k)
      *reinterpret_cast<uint4*>(s_w + tid * WORDS + 4 * k) =
          make_uint4(w[2 + 4 * k], w[3 + 4 * k], w[4 + 4 * k], w[5 + 4 * k]);
    if (tid == THREADS - 1) s_w[THREADS * WORDS] = w[NWIN - 1];
    if (tid == 0) *reinterpret_cast<uint2*>(smem + LEAD - 8) = make_uint2(w[0], w[1]);

    // 2-3. kept bytes (bit 7 of each byte; bit 6: after a 4-byte lead)
    // and the fast check
    uint32_t km[WORDS];
    uint32_t flag = 0;
    int cnt = 0;
    Classes cp = classes(w[1]);
    Special sp = special(w[1], cp);
    if (tid == 0) flag |= cp.l5;  // an F8-FF byte up to 4 before the tile
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const uint32_t x = w[2 + k];
      const Classes c = classes(x);
      const Special sx = special(x, c);
      flag |= check_word(x, c, sx, cp, sp);
      const uint32_t after4 = fwd(cp.l4 & ~cp.l5, c.l4 & ~c.l5, 1);
      uint32_t keep = ~c.cont & H;
      if (!full) {
        const long long q = s + 4 * k;
        keep = ((keep & below(q, length)) | after4) & below(q, n);
      } else {
        keep |= after4;
      }
      km[k] = keep | ((after4 & keep) >> 1);
      cnt += __popc(keep);
      cp = c;
      sp = sx;
    }
    if (tid == THREADS - 1) {  // events of the tile's last leads
      const Classes c = classes(w[NWIN - 1]);
      flag |= check_word(w[NWIN - 1], c, special(w[NWIN - 1], c), cp, sp);
    }

    int tile_cnt;
    int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_cnt);
    su::Triple own = su::triple(tile_cnt, tile_cnt, su::NO_EVENT);
    if (__syncthreads_or(flag != 0)) {
      // exact key of the lattice, and the units before it
      // (a rolled loop over the staged bytes: this path is rare, and its
      // registers would otherwise count against every tile's occupancy)
      unsigned long long key = su::NO_EVENT;
#pragma unroll 1
      for (int j = 0; j < PER && s + j < length; ++j) {
        const int r = tid * PER + j;
        const unsigned long long e =
            su::event_key(s + j, s_b[r], s_b[r + 1], s_b[r + 2], s_b[r + 3],
                          s_b[r - 1], s_b[r - 2], s_b[r - 3]);
        key = e < key ? e : key;
      }
      key = su::block_min_u64<NW>(key, s_key);
      int pre = 0;
      if (key != su::NO_EVENT) {
        const long long epos = (long long)(key >> 8);
#pragma unroll
        for (int k = 0; k < WORDS; ++k) pre += __popc(km[k] & H & below(s + 4 * k, epos));
      }
      pre = su::block_sum<NW>(pre, s_scan);
      own = su::triple(tile_cnt, key == su::NO_EVENT ? tile_cnt : pre, key);
    }
    // units of this tile that may be written (with the clamp, those before
    // its first error); the tile's kept offsets, in order
    const int lim = clamp && own.key != su::NO_EVENT ? own.before : tile_cnt;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const uint32_t bits = km[j >> 2] >> (8 * (j & 3) + 6);
      if (bits & 2) {
        if (slot < lim) s_u[slot] = (uint16_t)((tid * PER + j) | (bits & 1) << 15);
        ++slot;
      }
    }
    if (tid == 0) su::publish_aggregate(lb, t, own);
    __syncthreads();

    // 4-5. warp 0 looks back while the other warps decode each unit once
    if (tid < 32) {
      const su::Triple excl = t > 0 ? su::lookback_prefix(lb, t) : su::triple(0, 0, su::NO_EVENT);
      if (tid == 0) {
        const su::Triple inc = su::combine(excl, own);
        if (t > 0) su::publish_inclusive(lb, t, inc);
        s_excl = excl;
        if (t == nt - 1) {
          const bool bad = inc.key != su::NO_EVENT;
          res[0] = inc.count;
          res[1] = (long long)(inc.key >> 8);
          res[2] = (long long)(inc.key & 0xFF);
          res[3] = bad ? inc.before : 0;
          *err_any = bad;
        }
      }
    } else {
      constexpr int DW = THREADS - 32;  // decoding threads
      int u = tid - 32;
      for (; u + 3 * DW < lim; u += 4 * DW) {  // four independent units
        uint32_t e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = s_u[u + i * DW];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s_u[u + i * DW] = (uint16_t)unit_of<BE>(s_w, e[i] & 0x3FFF, e[i] >> 15);
      }
      for (; u < lim; u += DW) {
        const uint32_t e = s_u[u];
        s_u[u] = (uint16_t)unit_of<BE>(s_w, e & 0x3FFF, e >> 15);
      }
    }
    __syncthreads();
    const su::Triple excl = s_excl;
    if (clamp && excl.key != su::NO_EVENT) continue;  // after the first error

    // store units [0, lim) at out[base ..] as aligned 16-byte chunks
    const long long base = excl.count;
    const int sh = (int)(base & 7);
    uint16_t* dst = out + (base - sh);
    const int end = sh + lim;
    for (int c = tid; c * 8 < end; c += THREADS) {
      const int u0 = c * 8 - sh;  // shared index of the chunk's first unit
      if (vec_out && u0 >= 0 && u0 + 8 <= lim) {
        // five aligned words of s_u, shifted by the chunk's unit phase
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(s_u) + (u0 >> 1);
        const int ph = 16 * (u0 & 1);
        uint32_t q[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) q[i] = sw[i];
        __stcs(reinterpret_cast<uint4*>(dst + c * 8),
               make_uint4(__funnelshift_r(q[0], q[1], ph), __funnelshift_r(q[1], q[2], ph),
                          __funnelshift_r(q[2], q[3], ph), __funnelshift_r(q[3], q[4], ph)));
      } else {
        for (int i = u0 < 0 ? 0 : u0; i < u0 + 8 && i < lim; ++i) out[base + i] = s_u[i];
      }
    }
    // the next tile's barriers keep s_w and s_u until every store has read them
  }

  // the zero tail past out_len
  const su::Triple last = su::block_wait_inclusive(lb, nt - 1, &s_excl);
  const long long out_len =
      clamp && last.key != su::NO_EVENT ? last.before : last.count;
  su::zero_share(reinterpret_cast<uint8_t*>(out), 2 * out_len, 2 * n,
                 blockIdx.x, gridDim.x);
}

template <bool BE>
int launch(const uint8_t* b, long long n, long long length, int nt, int clamp,
           void* scratch, uint16_t* out, long long* res, uint8_t* err_any,
           cudaStream_t st) {
  static int cap = 0;
  if (cap == 0) {
    cudaFuncSetAttribute(compose16_kernel<BE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cap = su::resident_blocks(compose16_kernel<BE>, THREADS, SMEM);
  }
  const long long want = nt > (2 * n + 65535) / 65536 ? nt : (2 * n + 65535) / 65536;
  const int grid = want < cap ? (int)want : cap;
  compose16_kernel<BE><<<grid, THREADS, SMEM, st>>>(
      b, n, length, nt, clamp, su::lookback_carve(scratch, nt), out, res, err_any);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over nt = ceil(min(n, length + 1) / TILE) tiles (nt >= 1):
// out (uint16[n]) gets every unit, zero from out_len on; res (int64[4]) =
// total, err_pos (BIG when valid), err_code (0), err_len (0); *err_any
// = err_pos != BIG. `scratch` holds 16 + 48 nt bytes (lookback.cuh); its head is
// cleared here on `stream` first. Returns cudaGetLastError().
extern "C" int compose16(const uint8_t* b, long long n, long long length,
                         int nt, int big_endian, int clamp, void* scratch,
                         uint16_t* out, long long* res, uint8_t* err_any,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = su::lookback_reset(scratch, nt, st);
  if (rc != 0) return rc;
  return big_endian ? launch<true>(b, n, length, nt, clamp, scratch, out, res, err_any, st)
                    : launch<false>(b, n, length, nt, clamp, scratch, out, res, err_any, st);
}
