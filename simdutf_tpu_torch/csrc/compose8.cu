// utf16_to_utf8_compose: the general (mixed-width) UTF-16LE/BE -> UTF-8
// transcode in one launch (replaces the Pallas kernels _phase_b16_kernel
// and _phase_c16_kernel behind simdutf_tpu/kernels/butterfly16.to_utf8_compose),
// in two modes.
//
// Validating mode (VALID = false), the butterfly's accounting: each
// in-range unit emits 1, 2 or 3 bytes, and every surrogate 2, paired or
// not, so the total equals the "utf8len" count on any input; the first
// event is the first lone surrogate (key pos << 8 | SURROGATE), and no byte
// is written at or after the valid prefix's end.
// Valid-only mode (VALID = true), the accounting of the JAX package's
// convert_valid scatter engine (ops/utf16._codepoints, _utf8_widths,
// _emit_utf8): a high surrogate makes a code point with the next unit,
// whatever that unit is (0 at/after the length), a low surrogate writes
// nothing, every other unit its own code point; each code point takes 1-4
// bytes by its value, no event is reported and nothing is clamped but the
// buffer's end (a run of lone highs can ask for 4 bytes a unit, more than
// the 3N-byte buffer holds).
//
// A persistent grid walks tiles of 8192 units in the order of a global tile
// counter (lookback.cuh, on its wide slots: the byte counts need 64 bits).
// A tile is four rows of 2048 units, a thread taking 8 units of each row in
// one 16-byte load, so a warp's loads are 512 contiguous bytes. A block is
// eight data warps and one look-back warp. For each tile the data warps:
//  1. take the unit before and after each thread's eight from the
//     neighbouring lanes (a load at a warp's edge);
//  2. count each thread's bytes a row and scan the four counts at once,
//     packed in 16-bit fields of one 64-bit word: every unit's offset in
//     the tile's output. Only a row that holds a surrogate (valid text in
//     the BMP holds none) takes the exact path out of line, with its first
//     lone surrogate; a tile with an event takes the least key and the
//     bytes before it;
//  3. publish (bytes, least key, bytes before it) and hand it to the
//     look-back warp, which finds the tile's exclusive prefix (its output
//     offset, and whether the first error lies before it) while the data
//     warps stage the tile's bytes in shared memory and go on with the next
//     tile; its loads are issued as soon as the staging is done;
//  4. store the previous tile's staged bytes (two staging buffers) as
//     aligned 16-byte chunks at its offset, once the look-back warp has
//     handed it back: a tile after the first error writes nothing, the
//     error tile stops at the bytes before its event, and nothing goes at
//     or past 3N.
// A tile's look-back thus has a tile's count and staging to finish in, and
// folds windows of LOOK x 32 tiles: at ~40 tiles a microsecond, a window of
// 32 tiles a round trip would fall behind the tiles claimed meanwhile. Once
// the tiles are spent, each block waits for the last tile's inclusive value
// and zeroes its share of the output past out_len, so the wrapper needs no
// fill. The last tile's look-back writes total, err_pos, err_code, err_len
// and err_any.
//
// Floor: HBM bytes, one read of the 2-byte units and one write of the
// output bytes. The TPU compacts each tile with roll/select butterflies
// over four candidate byte planes because its scatter was slow; here a
// block scan gives each unit its output slot, and staging through shared
// memory turns each thread's scattered byte stores into contiguous 16-byte
// stores.
#include "lookback.cuh"
#include "utf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int ROW = THREADS * 8;        // units a row
constexpr int ROWS = 4;
constexpr int LOOK = 2;                // look-back window: LOOK x 32 tiles
constexpr long long TILE = ROW * ROWS;  // units a tile; = kernels/compose8.TILE

// UTF-8 bytes of code point cp (at most U+10FFFF + the valid-only mode's
// stray values below 2^21), first byte lowest; *w gets their number
__device__ __forceinline__ uint32_t cp_bytes(int cp, int* w) {
  const uint32_t c0 = 0x80 | (cp & 0x3F), c1 = 0x80 | ((cp >> 6) & 0x3F),
                 c2 = 0x80 | ((cp >> 12) & 0x3F);
  *w = 1 + (cp > 0x7F) + (cp > 0x7FF) + (cp > 0xFFFF);
  if (cp <= 0x7F) return cp;
  if (cp <= 0x7FF) return (0xC0 | (cp >> 6)) | c0 << 8;
  if (cp <= 0xFFFF) return (0xE0 | (cp >> 12)) | c1 << 8 | c0 << 16;
  return (0xF0 | (cp >> 18)) | c2 << 8 | c1 << 16 | c0 << 24;
}

// the bytes of a unit x that is no surrogate, branch-free
__device__ __forceinline__ uint32_t bmp_bytes(int x, int* w) {
  const uint32_t c0 = 0x80 | (x & 0x3F);
  const uint32_t b2 = (0xC0 | (x >> 6)) | c0 << 8;
  const uint32_t b3 = (0xE0 | (x >> 12)) | (0x80 | ((x >> 6) & 0x3F)) << 8 | c0 << 16;
  *w = 1 + (x >= 0x80) + (x >= 0x800);
  return x < 0x80 ? (uint32_t)x : x < 0x800 ? b2 : b3;
}

// the bytes of any in-range unit x, with the unit before it (prv) and
// after it (nxt), zero outside the in-range units
template <bool VALID>
__device__ __forceinline__ uint32_t unit_bytes(int prv, int x, int nxt, int* w) {
  if (!su::is_sur(x)) return bmp_bytes(x, w);
  if (VALID) {
    if (su::is_lo(x)) {  // starts nothing
      *w = 0;
      return 0;
    }
    return cp_bytes(((x - 0xD800) << 10) + (nxt - 0xDC00) + 0x10000, w);
  }
  *w = 2;
  if (su::is_hi(x)) {  // first two bytes of the pair's 4
    const int hb = x - 0xD7C0;  // cp >> 10
    return (0xF0 | (hb >> 8)) | (0x80 | ((hb >> 2) & 0x3F)) << 8;
  }
  const int hb = prv - 0xD7C0;  // last two, with two bits of the high
  return (0x80 | ((hb & 0x3) << 4) | ((x >> 6) & 0xF)) | (0x80 | (x & 0x3F)) << 8;
}

// 16 bytes of s from byte offset u; s + (u & ~15) is 16-byte aligned and
// 32 bytes from it may be read
__device__ __forceinline__ uint4 bytes16(const uint8_t* s, int u) {
  const uint4 a = *reinterpret_cast<const uint4*>(s + (u & ~15));
  const uint4 b = *reinterpret_cast<const uint4*>(s + (u & ~15) + 16);
  uint32_t q0, q1, q2, q3, q4;
  switch ((u >> 2) & 3) {  // the same for every chunk of a tile
    case 0: q0 = a.x, q1 = a.y, q2 = a.z, q3 = a.w, q4 = b.x; break;
    case 1: q0 = a.y, q1 = a.z, q2 = a.w, q3 = b.x, q4 = b.y; break;
    case 2: q0 = a.z, q1 = a.w, q2 = b.x, q3 = b.y, q4 = b.z; break;
    default: q0 = a.w, q1 = b.x, q2 = b.y, q3 = b.z, q4 = b.w; break;
  }
  const int ph = 8 * (u & 3);
  return make_uint4(__funnelshift_r(q0, q1, ph), __funnelshift_r(q1, q2, ph),
                    __funnelshift_r(q2, q3, ph), __funnelshift_r(q3, q4, ph));
}

// staged bytes of a tile: up to 3 a unit (4 in the valid-only mode), and
// 32 bytes more that bytes16 may read past the last one
template <bool VALID>
constexpr int STAGE = (int)TILE * (VALID ? 4 : 3) + 32;

// one row's eight units, two a word in native order: unit 2k in the low
// half of w[k], unit 2k + 1 in the high half
struct Row {
  uint32_t w[4];
};

// One row's eight units at p0, zero at/after `length`; and, for lane 0, the
// unit before them, for lane 31 the unit after them (the other lanes take
// theirs from their neighbours).
template <bool BE>
__device__ __forceinline__ void load_row(const uint16_t* __restrict__ w, long long p0,
                                         long long length, bool vec, int lane, Row& q,
                                         int& edge) {
  if (vec && p0 + 8 <= length) {
    const uint4 m = *reinterpret_cast<const uint4*>(w + p0);
    q.w[0] = m.x, q.w[1] = m.y, q.w[2] = m.z, q.w[3] = m.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q.w[k] = (p0 + 2 * k < length ? w[p0 + 2 * k] : 0u) |
               (p0 + 2 * k + 1 < length ? (uint32_t)w[p0 + 2 * k + 1] << 16 : 0u);
  }
  int e = 0;
  if (lane == 0 && p0 >= 1 && p0 - 1 < length) e = w[p0 - 1];
  if (lane == 31 && p0 + 8 < length) e = w[p0 + 8];
  if (BE) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q.w[k] = __byte_perm(q.w[k], 0, 0x2301);
    e = su::bswap16(e);
  }
  edge = e;
}

__device__ __forceinline__ int unit_at(const Row& q, int j) {
  return (j & 1) ? (int)(q.w[j >> 1] >> 16) : (int)(q.w[j >> 1] & 0xFFFF);
}

// the units before and after unit j of a row, from its words and pn (the
// unit before the row | the unit after it << 16)
__device__ __forceinline__ int prev_at(const Row& q, uint32_t pn, int j) {
  return j ? unit_at(q, j - 1) : (int)(pn & 0xFFFF);
}
__device__ __forceinline__ int next_at(const Row& q, uint32_t pn, int j) {
  return j < 7 ? unit_at(q, j + 1) : (int)(pn >> 16);
}

// in-range units of the row of eight at p0
__device__ __forceinline__ int in_row(long long length, long long p0) {
  const long long left = length - p0;
  return left >= 8 ? 8 : left > 0 ? (int)left : 0;
}

// The rows that hold a surrogate take these exact paths, out of line so
// that the unrolled fast path stays small (valid text in the BMP holds no
// surrogate). m is the row's in-range units, p0 its first unit's position.
struct Count {
  unsigned long long key;  // the row's first lone surrogate, or NO_EVENT
  int bytes;
};

template <bool VALID>
__device__ __noinline__ Count slow_count(Row q, uint32_t pn, int m, long long p0) {
  Count c{su::NO_EVENT, 0};
  for (int j = 0; j < m; ++j) {
    const int pv = prev_at(q, pn, j), x = unit_at(q, j), nx = next_at(q, pn, j);
    int wd;
    unit_bytes<VALID>(pv, x, nx, &wd);
    c.bytes += wd;
    if (!VALID && c.key == su::NO_EVENT && su::lone(pv, x, nx))
      c.key = ((unsigned long long)(p0 + j) << 8) | su::SURROGATE;
  }
  return c;
}

// the bytes of the row's units before unit je
template <bool VALID>
__device__ __noinline__ int slow_before(Row q, uint32_t pn, int je) {
  int before = 0;
  for (int j = 0; j < je; ++j) {
    int wd;
    unit_bytes<VALID>(prev_at(q, pn, j), unit_at(q, j), next_at(q, pn, j), &wd);
    before += wd;
  }
  return before;
}

template <bool VALID>
__device__ __noinline__ void slow_stage(Row q, uint32_t pn, int m, uint8_t* d) {
  for (int j = 0; j < m; ++j) {
    int wd;
    const uint32_t b = unit_bytes<VALID>(prev_at(q, pn, j), unit_at(q, j), next_at(q, pn, j), &wd);
    for (int k = 0; k < wd; ++k) d[k] = b >> (8 * k);
    d += wd;
  }
}

// barrier 1: the eight data warps alone
__device__ __forceinline__ void data_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }
__device__ __forceinline__ int data_sync_or(int p) {
  int r;
  asm volatile(
      "{\n .reg .pred a, b;\n setp.ne.s32 a, %1, 0;\n bar.red.or.pred b, 1, 256, a;\n"
      " selp.s32 %0, 1, 0, b;\n}"
      : "=r"(r)
      : "r"(p)
      : "memory");
  return r;
}

__device__ __forceinline__ unsigned long long data_scan64(unsigned long long v,
                                                          unsigned long long* s,
                                                          unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(su::FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s[warp] = inc;
  data_sync();
  unsigned long long base = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const unsigned long long x = s[k];
    base += k < warp ? x : 0;
    tot += x;
  }
  data_sync();
  *total = tot;
  return base + inc - v;
}

__device__ __forceinline__ unsigned long long data_min64(unsigned long long v,
                                                         unsigned long long* s) {
  v = su::warp_min_u64(v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  data_sync();
  unsigned long long r = s[0];
#pragma unroll
  for (int k = 1; k < NW; ++k) r = s[k] < r ? s[k] : r;
  data_sync();
  return r;
}

constexpr int ALL = THREADS + 32;  // the data warps and the look-back warp

template <bool VALID, bool BE>
__global__ void __launch_bounds__(ALL, 3)
    compose8_kernel(const uint16_t* __restrict__ w, long long length, int nt,
                    long long cap, su::WideLookback lb, uint8_t* __restrict__ out,
                    long long* __restrict__ res, uint8_t* __restrict__ err_any) {
  extern __shared__ __align__(16) uint8_t smem[];  // two staging buffers
  __shared__ unsigned long long s_scan[NW];
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_before;
  __shared__ int s_tile;
  __shared__ su::Wide s_own[2], s_excl[2], s_last;
  __shared__ int s_own_tile[2], s_first;
  // tiles handed over, each way: the value is written, fenced, then its
  // count; the reader waits for the count, fences, then reads the value
  __shared__ volatile int s_own_seq, s_excl_seq;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    s_own_seq = 0, s_excl_seq = 0;
    s_first = (int)atomicAdd(lb.counter, 1u);
  }
  __syncthreads();
  int t = s_first;

  if (tid >= THREADS) {
    // the look-back warp: tile i's exclusive prefix, while the data warps
    // count and stage the tiles after it
    for (int i = 0;; ++i) {
      while (s_own_seq <= i) __nanosleep(20);
      __threadfence_block();
      const int tt = s_own_tile[i & 1];
      if (tt >= nt) break;
      const su::Wide own = s_own[i & 1];
      const su::Wide ex = tt > 0 ? su::lookback_prefix<LOOK>(lb, tt) : su::wide(0, 0, su::NO_EVENT);
      if (lane == 0) {
        const su::Wide inc = su::combine(ex, own);
        if (tt > 0) su::publish(lb.incl + tt, inc);
        if (tt == nt - 1) {
          const bool bad = inc.key != su::NO_EVENT;
          res[0] = inc.count;
          res[1] = (long long)(inc.key >> 8);
          res[2] = (long long)(inc.key & 0xFF);
          res[3] = bad ? inc.before : 0;
          *err_any = bad;
        }
        s_excl[i & 1] = ex;
        __threadfence_block();
        s_excl_seq = i + 1;
      }
      __syncwarp();
    }
  } else {
    const bool vec = su::aligned16(w);
    Row q[ROWS];
    int edge[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      load_row<BE>(w, (long long)t * TILE + r * ROW + tid * 8, length, vec, lane, q[r], edge[r]);
    int prev_lim = 0;  // bytes the previous tile may store
    for (int i = 0;; ++i) {
      const bool live = t < nt;
      uint8_t* s_bytes = smem + (i & 1) * STAGE<VALID>;
      su::Wide own = su::wide(0, 0, su::NO_EVENT);
      int next = 0, tile_cnt = 0, slot[ROWS];
      uint32_t pn[ROWS];
      unsigned sur = 0;
      const long long t0 = (long long)t * TILE + tid * 8;
      if (live) {
        if (tid == 0) next = (int)atomicAdd(lb.counter, 1u);
        // 1. the units before and after each row's eight (prv | nxt << 16)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int up = __shfl_up_sync(su::FULL, unit_at(q[r], 7), 1);
          const int dn = __shfl_down_sync(su::FULL, unit_at(q[r], 0), 1);
          pn[r] = (lane == 0 ? edge[r] : up) | (lane == 31 ? edge[r] : dn) << 16;
        }
        // 2. bytes a row, scanned; the rows that hold a surrogate, and in
        // the validating mode this thread's least event key. Units past the
        // length read zero: one byte each in the plain count, taken off.
        unsigned long long packed = 0, key = su::NO_EVENT;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int m = in_row(length, t0 + r * ROW);
          int cnt = m - 8;
          bool s = false;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int x = unit_at(q[r], j);
            s |= su::is_sur(x);
            cnt += 1 + (x >= 0x80) + (x >= 0x800);
          }
          if (s) {
            const Count c = slow_count<VALID>(q[r], pn[r], m, t0 + r * ROW);
            cnt = c.bytes;
            if (c.key < key) key = c.key;
            sur |= 1u << r;
          }
          packed |= (unsigned long long)cnt << (16 * r);
        }
        unsigned long long tot;
        const unsigned long long excl = data_scan64(packed, s_scan, &tot);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          slot[r] = tile_cnt + (int)((excl >> (16 * r)) & 0xFFFF);
          tile_cnt += (int)((tot >> (16 * r)) & 0xFFFF);
        }
        own = su::wide(tile_cnt, tile_cnt, su::NO_EVENT);
        if (!VALID && data_sync_or(key != su::NO_EVENT)) {
          const unsigned long long kmin = data_min64(key, s_key);
          if (key == kmin) {
            const int e = (int)((long long)(kmin >> 8) - t0);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              if (e / ROW == r) s_before = slot[r] + slow_before<VALID>(q[r], pn[r], e % 8);
          }
          data_sync();
          own = su::wide(tile_cnt, s_before, kmin);
        }
        if (tid == 0) su::publish_aggregate(lb, t, own);
      }
      if (tid == 0) {  // hand tile i (or the end) to the look-back warp
        s_own[i & 1] = own;
        s_own_tile[i & 1] = live ? t : nt;
        __threadfence_block();
        s_own_seq = i + 1;
      }
      // 3. stage the tile's bytes; zero units past the length stage a zero
      // byte each after their row's bytes, where only units past the length
      // follow, so past tile_cnt, which no store reads. Then the next tile's
      // loads go out.
      int tn = nt;
      if (live) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          uint8_t* d = s_bytes + slot[r];
          if (sur >> r & 1) {
            slow_stage<VALID>(q[r], pn[r], in_row(length, t0 + r * ROW), d);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {  // bmp_bytes, a byte at a time
              const int x = unit_at(q[r], j);
              const bool a2 = x >= 0x80, a3 = x >= 0x800;
              uint8_t* dn = d + 1 + a2 + a3;
              d[0] = (x >> (a3 ? 12 : a2 ? 6 : 0)) | (a3 ? 0xE0 : a2 ? 0xC0 : 0);
              if (a2) dn[-1] = 0x80 | (x & 0x3F);
              if (a3) d[1] = 0x80 | ((x >> 6) & 0x3F);
              d = dn;
            }
          }
        }
        if (tid == 0) s_tile = next;
        data_sync();  // the staged bytes and the next claim
        tn = s_tile;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          load_row<BE>(w, (long long)tn * TILE + r * ROW + tid * 8, length, vec, lane, q[r], edge[r]);
      }
      // 4. the previous tile's bytes [0, lim) at out[base ..], below cap,
      // once its prefix is in; nothing after the first error
      if (i > 0) {
        while (s_excl_seq < i) __nanosleep(20);
        __threadfence_block();
        const su::Wide ex = s_excl[(i - 1) & 1];
        const uint8_t* sb = smem + ((i - 1) & 1) * STAGE<VALID>;
        if (VALID || ex.key == su::NO_EVENT) {
          const long long base = ex.count;
          long long lim = prev_lim;
          if (lim > cap - base) lim = cap - base;
          const int sh = (int)((reinterpret_cast<uintptr_t>(out) + base) & 15);
          const long long end = sh + lim;
          for (int c = tid; 16ll * c < end; c += THREADS) {
            const int u0 = 16 * c - sh;
            if (u0 >= 0 && u0 + 16 <= lim) {
              __stcs(reinterpret_cast<uint4*>(out + base + u0), bytes16(sb, u0));
            } else {
              for (int k = u0 < 0 ? 0 : u0; k < u0 + 16 && k < lim; ++k) out[base + k] = sb[k];
            }
          }
        }
      }
      if (!live) break;
      prev_lim = own.key != su::NO_EVENT ? (int)own.before : tile_cnt;
      t = tn;
    }
  }

  // the zero tail past out_len
  __syncthreads();
  const su::Wide last = su::block_wait_inclusive(lb, nt - 1, &s_last);
  long long out_len = !VALID && last.key != su::NO_EVENT ? last.before : last.count;
  if (out_len > cap) out_len = cap;
  su::zero_share(out, out_len, cap, blockIdx.x, gridDim.x);
}

template <bool VALID, bool BE>
int launch(const uint16_t* w, long long n, long long length, int nt, void* scratch,
           uint8_t* out, long long* res, uint8_t* err_any, cudaStream_t st) {
  constexpr int SMEM = 2 * STAGE<VALID>;
  static int grid_cap = 0;
  if (grid_cap == 0) {
    cudaFuncSetAttribute(compose8_kernel<VALID, BE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    grid_cap = su::resident_blocks(compose8_kernel<VALID, BE>, ALL, SMEM);
  }
  const long long cap = 3 * n;
  const long long zero_blocks = (cap + 65535) / 65536;
  const long long want = nt > zero_blocks ? nt : zero_blocks;
  const int grid = want < grid_cap ? (int)want : grid_cap;
  compose8_kernel<VALID, BE><<<grid, ALL, SMEM, st>>>(
      w, length, nt, cap, su::wide_lookback_carve(scratch, nt), out, res, err_any);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over nt = ceil(length / TILE) tiles (nt >= 1): out (uint8[3n])
// gets the UTF-8 bytes of w[:length] (units byte-swapped when be), zero from
// out_len on; res (int64[4]) = total, err_pos (BIG when none), err_code (0
// when none), err_len (0 when none); *err_any = err_pos != BIG. The
// valid-only mode (valid) reports no event, and its total may exceed 3n.
// `scratch` holds 16 + 48 nt bytes (lookback.cuh's wide slots); it is
// cleared here on `stream` first. Returns cudaGetLastError().
extern "C" int compose8(const uint16_t* w, long long n, long long length, int be,
                        int valid, int nt, void* scratch, uint8_t* out, long long* res,
                        uint8_t* err_any, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = su::wide_lookback_reset(scratch, nt, st);
  if (rc != 0) return rc;
  if (valid)
    return be ? launch<true, true>(w, n, length, nt, scratch, out, res, err_any, st)
              : launch<true, false>(w, n, length, nt, scratch, out, res, err_any, st);
  return be ? launch<false, true>(w, n, length, nt, scratch, out, res, err_any, st)
            : launch<false, false>(w, n, length, nt, scratch, out, res, err_any, st);
}
