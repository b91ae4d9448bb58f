// utf8_to_utf16_compose: the general (mixed-script) validating UTF-8 ->
// UTF-16LE/BE transcode in one launch (replaces the Pallas kernels
// _phase_b_kernel and _phase_c_kernel behind
// simdutf_tpu/kernels/butterfly.to_utf16_compose).
//
// A persistent grid walks 16 KiB tiles (256 threads x 64 bytes) in the
// order of a global tile counter (lookback.cuh). A block is eight data warps
// and one look-back warp. For each tile the data warps:
//  1. hold its bytes in registers, 64 a thread with 8 bytes of halo before
//     and 4 after, loaded while the previous tile was stored;
//  2. mark the bytes that carry a unit (an in-range lead, or the byte after
//     a 4-byte lead, which may sit at `length` itself), count them four
//     bytes at a time on 32-bit words, and scan the counts: each thread's
//     first slot in the tile's units;
//  3. run a fast check that may flag valid text but never misses an event
//     of the error lattice: a structural test (every byte a lead asks for
//     is a continuation and no other byte is) and the value tests of
//     simdutf's lookup tables (C0/C1, E0 and ED, F0 and F4-F7 against the
//     next byte, F8-FF), as bit masks on the words. Only a tile the check
//     flags stages its bytes and computes the exact key of utf8.cuh's
//     event_key lattice and the units before it. The window, the marks, the
//     check and the exact key are utf8_tile.cuh's, shared with compose32.cu;
//  4. publish (units, least key, units before it) and hand it to the
//     look-back warp, which finds the tile's exclusive prefix (its output
//     offset, and whether the first error lies before it) while the data
//     warps decode the tile and go on with the next one;
//  5. decode each unit where its bytes are, in the registers of the thread
//     that owns its byte, and write it once to its slot in one of two
//     staging buffers. On a tile the check passed, a warp with no 4-byte
//     lead among its bytes (and the one before them) accumulates each
//     sequence's payload as its bytes go by and writes the unit when the
//     next byte is no continuation; any other warp decodes each marked byte
//     on its own, branch-free (su::lead_cp; the high surrogate at a 4-byte
//     lead, the low at the byte after it), which is exact on any input.
//     Then the next tile's loads go out;
//  6. store the previous tile's units as aligned 16-byte chunks at its
//     offset, once the look-back warp has handed it back. With the clamp, a
//     tile after the first error writes no unit and the error tile stops at
//     the units before it; without it every in-range lead writes its
//     unit(s), past the error too.
// The zeros past out_len go out with the tiles, so that no block waits at
// the end for the last prefix and the wrapper needs no fill: a tile zeroes
// whatever of its units' span the clamp leaves, and, since the units after
// it number at most the bytes after it that may carry one, the stretch
// between its bound on the total and the bound before it (TILE less its
// units); the blocks share the zeros past the last byte that may carry a
// unit. The last tile's look-back writes total, err_pos, err_code, err_len
// and err_any.
//
// Floor: HBM bytes, one read of the input and one write of the whole
// uint16 output. Above it, the kernel is bound by integer instructions a
// byte (the check ~14 on the words, the accumulating decode ~9) and by the
// look-back's latency: at ~30 tiles a microsecond a tile's prefix walks
// back over the few hundred tiles still in flight (PERF.md).
#include "utf8_tile.cuh"

namespace {

constexpr int THREADS = 256;                // data threads
constexpr int ALL = THREADS + 32;           // and the look-back warp
constexpr int NW = THREADS / 32;
constexpr int PER = 64;                     // bytes a thread
constexpr int WORDS = PER / 4;              // 16
constexpr int TILE = THREADS * PER;         // = kernels/compose16.TILE
constexpr int NWIN = WORDS + 3;             // window words (utf8_tile.cuh)

// A staging buffer: a tile's units (at most one a byte), and a word that the
// store may read past the last one. A tile the fast check flags first
// stages its bytes there for the exact key, from LEAD on (8 bytes of halo
// before, 4 after), before its units overwrite them.
constexpr int LEAD = 16;
constexpr int STAGE = 2 * TILE + 16;

// a unit in the output's byte order
template <bool BE>
__device__ __forceinline__ uint16_t order(uint32_t v) {
  return (uint16_t)(BE ? __byte_perm(v, 0, 0x3201) : v);
}

// The unit of a marked byte whose bytes from it are X (little-endian; `a4`:
// the byte before it is a 4-byte lead), branch-free: the lead's code point
// (su::lead_cp), its high surrogate above 0xFFFF, and the byte after a
// 4-byte lead its low surrogate.
template <bool BE>
__device__ __forceinline__ uint16_t unit_of(uint32_t X, bool a4) {
  const uint32_t cp = su::lead_cp(X);
  uint32_t v = cp > 0xFFFF ? 0xD7C0 + (cp >> 10) : cp;
  if (a4) v = 0xDC00 | ((X & 0x0F00) >> 2) | (X >> 16 & 0x3F);
  return order<BE>(v);
}

// Every marked byte's unit, in order from u: exact on any input.
template <bool BE>
__device__ __forceinline__ void decode_marked(const uint32_t (&w)[NWIN],
                                              const uint32_t (&km)[WORDS], uint16_t* u) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const uint32_t bits = km[j >> 2] >> (8 * (j & 3) + 6);
    if (bits & 2) {
      const int k = 2 + (j >> 2);
      *u++ = unit_of<BE>(__funnelshift_r(w[k], w[k + 1], 8 * (j & 3)), bits & 1);
    }
  }
}

// The units of the thread's leads, from u, on a tile the fast check passed
// and in a warp with no 4-byte lead among its bytes and the one before
// them: every sequence is whole, valid and at most 3 bytes long, so its
// unit is its lead's payload followed by its continuations' six bits each.
// They accumulate as the bytes go by; a lead writes the unit of the
// sequence before it if that began in the thread (at most two
// continuations of an earlier thread's sequence come first), and the
// thread's last sequence takes its continuations from the bytes after the
// thread's own.
template <bool BE>
__device__ __forceinline__ void decode_runs(const uint32_t (&w)[NWIN], uint16_t* u) {
  uint16_t* const first = u;
  --u;  // the slot of the sequence in hand
  uint32_t acc = 0;
  bool more = true;  // past the thread's bytes: still its last sequence
#pragma unroll
  for (int k = 0; k <= WORDS; ++k) {
    const uint32_t x = w[2 + k];
    const uint32_t hi = x & su::H, lead = hi & (x << 1);
    const uint32_t cont = hi & ~(x << 1);
    // payload: bit 7 cleared, and bit 6 of every byte >= 0x80, bit 5 of
    // every lead, bit 4 of every 3-byte lead
    const uint32_t pay = x & ~(su::H | hi >> 1 | lead >> 2 | (lead & (x << 2)) >> 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool c = cont >> (8 * i + 7) & 1;
      const uint32_t q = pay >> (8 * i) & 0xFF;
      if (k < WORDS) {
        if (!c) {
          if (4 * k + i > 2 || u >= first) *u = order<BE>(acc);
          ++u;
          acc = q;
        } else {
          acc = acc * 64 + q;
        }
      } else if (i < 3) {
        more = more && c;
        if (more) acc = acc * 64 + q;
      }
    }
  }
  if (u >= first) *u = order<BE>(acc);
}

// out[lo, hi) (bytes) zeroed by the data threads, 16 bytes a store where
// aligned
__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ out, long long lo,
                                           long long hi) {
  if (lo >= hi) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  long long c0 = (long long)(((a + lo + 15) & ~(uintptr_t)15) - a);  // first aligned byte
  long long c1 = (long long)(((a + hi) & ~(uintptr_t)15) - a);       // end of whole chunks
  if (c0 > hi) c0 = hi;
  if (c1 < c0) c1 = c0;
  const int tid = threadIdx.x;
  for (long long k = lo + tid; k < c0; k += THREADS) out[k] = 0;
  for (long long k = c1 + tid; k < hi; k += THREADS) out[k] = 0;
  uint4* o = reinterpret_cast<uint4*>(out + c0);
  for (long long k = tid; k < (c1 - c0) / 16; k += THREADS) __stcs(o + k, make_uint4(0, 0, 0, 0));
}

// Barriers and reductions of the eight data warps alone (barrier 1), while
// the look-back warp runs on.
__device__ __forceinline__ void data_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ int data_sync_or(int p) {
  int r;
  asm volatile(
      "{\n .reg .pred a, b;\n setp.ne.s32 a, %1, 0;\n bar.red.or.pred b, 1, %2, a;\n"
      " selp.s32 %0, 1, 0, b;\n}"
      : "=r"(r)
      : "r"(p), "n"(THREADS)
      : "memory");
  return r;
}

// exclusive scan of v over the data threads; *total gets their sum
__device__ __forceinline__ int data_excl_scan(int v, int* s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(su::FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s[warp] = inc;
  data_sync();
  int base = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int x = s[k];
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

__device__ __forceinline__ int data_sum(int v, int* s) {
  v = __reduce_add_sync(su::FULL, v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  data_sync();
  int r = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) r += s[k];
  data_sync();
  return r;
}

template <bool BE>
__global__ void __launch_bounds__(ALL, 3)
    compose16_kernel(const uint8_t* __restrict__ b, long long n,
                     long long length, int nt, int clamp, su::Lookback lb,
                     uint16_t* __restrict__ out, long long* __restrict__ res,
                     uint8_t* __restrict__ err_any) {
  extern __shared__ __align__(16) uint8_t smem[];  // two staging buffers
  __shared__ int s_scan[NW];
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_tile;
  __shared__ su::Triple s_own[2], s_excl[2];
  __shared__ int s_own_tile[2];
  // tiles handed over, each way: the value is written, fenced, then its
  // count; the reader waits for the count, fences, then reads the value
  __shared__ volatile int s_own_seq, s_excl_seq;
  const int tid = threadIdx.x, lane = tid & 31;
  // the bytes that may carry a unit end at l1, so units end there too
  const long long l1 = length + 1 < n ? length + 1 : n;

  if (tid == 0) {
    s_own_seq = 0, s_excl_seq = 0;
    s_tile = (int)atomicAdd(lb.counter, 1u);
  }
  __syncthreads();
  int t = s_tile;

  if (tid >= THREADS) {
    // the look-back warp: tile i's exclusive prefix, while the data warps
    // decode it and go on with the tiles after it
    for (int i = 0;; ++i) {
      while (s_own_seq <= i) __nanosleep(20);
      __threadfence_block();
      const int tt = s_own_tile[i & 1];
      if (tt >= nt) break;
      const su::Triple own = s_own[i & 1];
      const su::Triple ex =
          tt > 0 ? su::lookback_prefix(lb, tt) : su::triple(0, 0, su::NO_EVENT);
      if (lane == 0) {
        const su::Triple inc = su::combine(ex, own);
        if (tt > 0) su::publish_inclusive(lb, tt, inc);
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
    const bool vec_in = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
    const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    uint32_t w[NWIN];
    bool full = false;
    if (t < nt) full = su::load_window<WORDS>(b, (long long)t * TILE + tid * PER, length, vec_in, w);
    int prev_t = 0, prev_cnt = 0, prev_lim = 0;  // the previous tile, its units, those it may store
    for (int i = 0;; ++i) {
      const bool live = t < nt;
      uint8_t* const buf = smem + (i & 1) * STAGE;
      int next = 0, tile_cnt = 0, lim = 0;
      if (live) {
        if (tid == 0) next = (int)atomicAdd(lb.counter, 1u);
        const long long s = (long long)t * TILE + tid * PER;
        // 2-3. marked bytes (bit 7 of each byte; bit 6: after a 4-byte
        // lead), the slots, and the fast check
        uint32_t km[WORDS];
        int cnt;
        const uint32_t flag =
            su::mark_and_check<WORDS, true, THREADS>(w, s, length, n, full, km, &cnt);
        const int slot = data_excl_scan(cnt, s_scan, &tile_cnt);
        su::Triple own = su::triple(tile_cnt, tile_cnt, su::NO_EVENT);
        const bool flagged = data_sync_or(flag != 0);
        if (flagged) {  // exact key of the lattice, units before it
          uint32_t* s_w = reinterpret_cast<uint32_t*>(buf + LEAD);
#pragma unroll
          for (int m = 0; m < WORDS / 4; ++m)
            *reinterpret_cast<uint4*>(s_w + tid * WORDS + 4 * m) =
                make_uint4(w[2 + 4 * m], w[3 + 4 * m], w[4 + 4 * m], w[5 + 4 * m]);
          if (tid == THREADS - 1) s_w[THREADS * WORDS] = w[NWIN - 1];
          if (tid == 0) *reinterpret_cast<uint2*>(buf + LEAD - 8) = make_uint2(w[0], w[1]);
          data_sync();
          const unsigned long long key =
              data_min64(su::exact_key<WORDS>(buf + LEAD, s, length), s_key);
          if (key != su::NO_EVENT) {
            const int before = su::marked_before(km, s, (long long)(key >> 8));
            own = su::triple(tile_cnt, data_sum(before, s_scan), key);
          }
        }
        if (tid == 0) {  // publish; hand tile i to the look-back warp
          su::publish_aggregate(lb, t, own);
          s_own[i & 1] = own;
          s_own_tile[i & 1] = t;
          __threadfence_block();
          s_own_seq = i + 1;
        }
        // 5. the units, one shared-memory write each (the staged bytes, if
        // any, were read before data_min64's barriers). A warp with a
        // 4-byte lead among its bytes or the one before them (marked bytes
        // after one have bit 6; the last byte may be one) decodes each
        // marked byte on its own, as a flagged tile does.
        uint16_t* const s_u = reinterpret_cast<uint16_t*>(buf) + slot;
        uint32_t after4 = 0;
#pragma unroll
        for (int m = 0; m < WORDS; ++m) after4 |= km[m];
        if (flagged ||
            __any_sync(su::FULL, (after4 & 0x40404040u) || w[NWIN - 2] >= 0xF0000000u))
          decode_marked<BE>(w, km, s_u);
        else
          decode_runs<BE>(w, s_u);
        lim = clamp && own.key != su::NO_EVENT ? own.before : tile_cnt;
        if (tid == 0) s_tile = next;
      } else if (tid == 0) {  // hand the end to the look-back warp
        s_own_tile[i & 1] = nt;
        __threadfence_block();
        s_own_seq = i + 1;
      }
      // the staged units and the next claim; then the next tile's loads
      data_sync();
      const int tn = live ? s_tile : nt;
      if (tn < nt)
        full = su::load_window<WORDS>(b, (long long)tn * TILE + tid * PER, length, vec_in, w);

      // 6. the previous tile, once its prefix is in: its units [0, prev_lim)
      // at out[base ..] (with the clamp, none after the first error) and
      // zeros over the rest of its units' span; and the zeros past its
      // bound on the total (its inclusive count plus the bytes after it
      // that may carry a unit) up to the previous tile's bound
      if (i > 0) {
        while (s_excl_seq < i) __nanosleep(20);
        __threadfence_block();
        const su::Triple ex = s_excl[(i - 1) & 1];
        const uint16_t* pu = reinterpret_cast<const uint16_t*>(smem + ((i - 1) & 1) * STAGE);
        const long long base = ex.count;
        const int stored = clamp && ex.key != su::NO_EVENT ? 0 : prev_lim;
        const int sh = (int)(base & 7);
        uint16_t* dst = out + (base - sh);
        const int end = sh + stored;
        for (int c = tid; c * 8 < end; c += THREADS) {
          const int u0 = c * 8 - sh;  // staged index of the chunk's first unit
          if (vec_out && u0 >= 0 && u0 + 8 <= stored) {
            // five aligned words of the units, shifted by the chunk's unit phase
            const uint32_t* sw = reinterpret_cast<const uint32_t*>(pu) + (u0 >> 1);
            const int ph = 16 * (u0 & 1);
            uint32_t q[5];
#pragma unroll
            for (int m = 0; m < 5; ++m) q[m] = sw[m];
            __stcs(reinterpret_cast<uint4*>(dst + c * 8),
                   make_uint4(__funnelshift_r(q[0], q[1], ph), __funnelshift_r(q[1], q[2], ph),
                              __funnelshift_r(q[2], q[3], ph), __funnelshift_r(q[3], q[4], ph)));
          } else {
            for (int m = u0 < 0 ? 0 : u0; m < u0 + 8 && m < stored; ++m) out[base + m] = pu[m];
          }
        }
        uint8_t* o8 = reinterpret_cast<uint8_t*>(out);
        zero_bytes(o8, 2 * (base + stored), 2 * (base + prev_cnt));
        const long long after = l1 - (long long)(prev_t + 1) * TILE, from = l1 - (long long)prev_t * TILE;
        zero_bytes(o8, 2 * (base + prev_cnt + (after > 0 ? after : 0)),
                   2 * (base + (from > 0 ? from : 0)));
      }
      if (!live) break;
      prev_t = t, prev_cnt = tile_cnt, prev_lim = lim;
      t = tn;
    }
  }

  // the zeros past l1, which no tile's bound reaches
  su::zero_share(reinterpret_cast<uint8_t*>(out), 2 * l1, 2 * n, blockIdx.x, gridDim.x);
}

template <bool BE>
int launch(const uint8_t* b, long long n, long long length, int nt, int clamp, int blocks,
           void* scratch, uint16_t* out, long long* res, uint8_t* err_any,
           cudaStream_t st) {
  constexpr int SMEM = 2 * STAGE;
  static int cap = 0;
  if (cap == 0) {
    cudaFuncSetAttribute(compose16_kernel<BE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cap = su::resident_blocks(compose16_kernel<BE>, ALL, SMEM);
  }
  const long long want = nt > (2 * n + 65535) / 65536 ? nt : (2 * n + 65535) / 65536;
  int grid = want < cap ? (int)want : cap;
  if (blocks > 0 && blocks < grid) grid = blocks;
  compose16_kernel<BE><<<grid, ALL, SMEM, st>>>(
      b, n, length, nt, clamp, su::lookback_carve(scratch, nt), out, res, err_any);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over nt = ceil(min(n, length + 1) / TILE) tiles (nt >= 1):
// out (uint16[n]) gets every unit, zero from out_len on; res (int64[4]) =
// total, err_pos (BIG when valid), err_code (0), err_len (0); *err_any
// = err_pos != BIG. `scratch` holds 16 + 48 nt bytes (lookback.cuh); its head is
// cleared here on `stream` first. `blocks` > 0 caps the grid (the tests run
// every tile through one block); 0 takes as many as are resident at once.
// Returns cudaGetLastError().
extern "C" int compose16_grid(const uint8_t* b, long long n, long long length, int nt,
                              int big_endian, int clamp, int blocks, void* scratch,
                              uint16_t* out, long long* res, uint8_t* err_any,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = su::lookback_reset(scratch, nt, st);
  if (rc != 0) return rc;
  return big_endian
             ? launch<true>(b, n, length, nt, clamp, blocks, scratch, out, res, err_any, st)
             : launch<false>(b, n, length, nt, clamp, blocks, scratch, out, res, err_any, st);
}

// compose16_grid on as many blocks as are resident at once.
extern "C" int compose16(const uint8_t* b, long long n, long long length,
                         int nt, int big_endian, int clamp, void* scratch,
                         uint16_t* out, long long* res, uint8_t* err_any,
                         void* stream) {
  return compose16_grid(b, n, length, nt, big_endian, clamp, 0, scratch, out, res,
                        err_any, stream);
}
