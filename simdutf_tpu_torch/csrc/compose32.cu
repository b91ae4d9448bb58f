// utf8_to_utf32_compose: the general (mixed-script) validating UTF-8 ->
// UTF-32 transcode in one launch (replaces the Pallas kernels _phase_b32
// and _phase_c32 behind simdutf_tpu/kernels/butterfly32.to_utf32_compose).
//
// A persistent grid walks TILE-byte tiles (THREADS data threads x PER
// bytes) in the order of a global tile counter (lookback.cuh). A block is
// its data warps and one look-back warp. For each tile the data warps:
//  1. hold its bytes in registers, PER a thread with 8 bytes of halo before
//     and 4 after, loaded while the previous tile was stored;
//  2. mark the in-range leads (every byte that is not a continuation: one
//     word each, F8-FF included), count them four bytes at a time and scan
//     the counts: each thread's first slot in the tile's words;
//  3. run the fast check of utf8_tile.cuh, which may flag valid text but
//     never misses an event of utf8.cuh's event_key lattice; only a tile
//     the check flags stages its bytes and computes the exact key and the
//     words before it;
//  4. publish (words, least key, words before it) and hand it to the
//     look-back warp, which finds the tile's exclusive prefix (its output
//     offset) while the data warps decode the tile and go on with the next;
//  5. decode each word where its bytes are, in the registers of the thread
//     that owns its lead, and write it once to its slot in one of two
//     staging buffers. On a tile the check passed, a warp with no 4-byte
//     lead among its bytes (and the byte before them) accumulates each
//     sequence's payload as its bytes go by and writes the word when the
//     next byte is no continuation; any other warp decodes each lead on its
//     own, branch-free (su::lead_cp: 0 for F8-FF, a cut sequence reads the
//     zero bytes past `length`), which is exact on any input. Each tile
//     writes how many of its warps accumulated into its look-back slot's
//     first extra word (kernels/compose32._tile_paths reads it). Then the
//     next tile's loads go out;
//  6. store the previous tile's words as aligned 16-byte chunks at its
//     offset, once the look-back warp has handed it back.
// Every lead writes its word, past the first error too, on valid and
// invalid input alike: the JAX package's UTF-32 engine
// (ops/utf8._to_utf32_general) leaves the decoded rest of the buffer in
// place past out_len, and the TPU butterfly's err_any rerun of it gives the
// same final buffer. The zeros past the total go out with the tiles, so
// that no block waits at the end for the last prefix and the wrapper needs
// no fill: the words after a tile number at most its in-range bytes after
// it, so its inclusive count plus those bytes bounds the total, and the
// tile zeroes the stretch between its bound and the bound before it (its
// in-range bytes less its words); the blocks share the zeros past `length`.
// The last tile's look-back writes total, err_pos, err_code, err_len and
// err_any.
//
// Floor: HBM bytes, one read of the input and one write of the whole int32
// output (4 bytes a byte of input: the output is 80% of the traffic, the
// zeros past the total about half of it on mixed text). Above it, the
// kernel is bound by integer instructions a byte (the check ~14 on the
// words, the accumulating decode ~9) and by the look-back's latency: a
// tile's prefix takes its look-back warp ~6 us, most of the time the data
// warps spend on the next tile. A tile's words take 4 bytes a byte of
// shared memory, so the tiles are 8 KiB: two 32 KiB staging buffers a
// block, three blocks a SM (72 registers, no spills). 16 KiB tiles at one
// block a SM were 8% slower on mixed text, and 12 KiB tiles at two within
// 1% there but 1-3% slower on emoji-rich text (PERF.md).
#include "utf8_tile.cuh"

namespace {

constexpr int THREADS = 256;                // data threads
constexpr int ALL = THREADS + 32;           // and the look-back warp
constexpr int PER = 32;                     // bytes a thread
constexpr int WORDS = PER / 4;              // 8
constexpr int TILE = THREADS * PER;         // = kernels/compose32.TILE
constexpr int NWIN = WORDS + 3;             // window words (utf8_tile.cuh)
constexpr int BLOCKS = 3;                   // resident a SM

// A staging buffer: a tile's words (at most one a byte), and a chunk that
// the store may read past the last one. A tile the fast
// check flags first stages its bytes there for the exact key, from LEAD on
// (8 bytes of halo before, 4 after), before its words overwrite them.
constexpr int LEAD = 16;
constexpr int STAGE = 4 * TILE + 16;
static_assert(LEAD + TILE + 16 <= STAGE, "a flagged tile's bytes fit a buffer");

// Every lead's word, in order from u: exact on any input.
__device__ __forceinline__ void decode_leads(const uint32_t (&w)[NWIN],
                                             const uint32_t (&km)[WORDS], uint32_t* u) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (km[j >> 2] >> (8 * (j & 3) + 7) & 1) {
      const int k = 2 + (j >> 2);
      *u++ = su::lead_cp(__funnelshift_r(w[k], w[k + 1], 8 * (j & 3)));
    }
  }
}

// The words of the thread's leads, from u, on a tile the fast check passed
// and in a warp with no 4-byte lead among its bytes and the byte before
// them: every sequence is whole, valid and at most 3 bytes long, so its
// word is its lead's payload followed by its continuations' six bits each.
// They accumulate as the bytes go by; a lead writes the word of the
// sequence before it if that began in the thread (at most two
// continuations of an earlier thread's sequence come first), and the
// thread's last sequence takes its continuations from the bytes after the
// thread's own. Bytes past `length` are zero, so each writes a word past
// the tile's count, which is never stored.
__device__ __forceinline__ void decode_runs(const uint32_t (&w)[NWIN], uint32_t* u) {
  uint32_t* const first = u;
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
          if (4 * k + i > 2 || u >= first) *u = acc;
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
  if (u >= first) *u = acc;
}

// Whether a byte >= 0xF0 lies among the thread's bytes or the byte before
// them.
__device__ __forceinline__ bool holds_lead4(const uint32_t (&w)[NWIN]) {
  uint32_t m = w[1] & 0xF0000000u;
  m = m == 0xF0000000u ? su::H : 0u;
#pragma unroll
  for (int k = 2; k < 2 + WORDS; ++k) {
    const uint32_t x = w[k] & (w[k] << 2);  // bit 7: bits 7 and 5; bit 6: 6 and 4
    m |= x & (x << 1);
  }
  return (m & su::H) != 0;
}

__global__ void __launch_bounds__(ALL, BLOCKS)
    compose32_kernel(const uint8_t* __restrict__ b, long long n,
                     long long length, int nt, su::Lookback lb,
                     uint32_t* __restrict__ out, long long* __restrict__ res,
                     uint8_t* __restrict__ err_any) {
  extern __shared__ __align__(16) uint8_t smem[];  // two staging buffers
  __shared__ int s_scan[THREADS / 32];
  __shared__ unsigned long long s_key[THREADS / 32];
  __shared__ int s_tile;
  __shared__ su::Triple s_own[2], s_excl[2];
  __shared__ int s_own_tile[2];
  // tiles handed over, each way: the value is written, fenced, then its
  // count; the reader waits for the count, fences, then reads the value
  __shared__ volatile int s_own_seq, s_excl_seq;
  const int tid = threadIdx.x, lane = tid & 31;

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
    int prev_t = 0, prev_cnt = 0;  // the previous tile and its words
    for (int i = 0;; ++i) {
      const bool live = t < nt;
      uint8_t* const buf = smem + (i & 1) * STAGE;
      int next = 0, tile_cnt = 0;
      bool runs = false;
      if (live) {
        if (tid == 0) next = (int)atomicAdd(lb.counter, 1u);
        const long long s = (long long)t * TILE + tid * PER;
        // 2-3. the leads (bit 7 of each byte), the slots, and the fast check
        uint32_t km[WORDS];
        int cnt;
        const uint32_t flag =
            su::mark_and_check<WORDS, false, THREADS>(w, s, length, n, full, km, &cnt);
        const int slot = su::data_excl_scan<THREADS>(cnt, s_scan, &tile_cnt);
        su::Triple own = su::triple(tile_cnt, tile_cnt, su::NO_EVENT);
        const bool flagged = su::data_sync_or<THREADS>(flag != 0);
        if (flagged) {  // exact key of the lattice, words before it
          uint32_t* s_w = reinterpret_cast<uint32_t*>(buf + LEAD);
#pragma unroll
          for (int m = 0; m < WORDS / 4; ++m)
            *reinterpret_cast<uint4*>(s_w + tid * WORDS + 4 * m) =
                make_uint4(w[2 + 4 * m], w[3 + 4 * m], w[4 + 4 * m], w[5 + 4 * m]);
          if (tid == THREADS - 1) s_w[THREADS * WORDS] = w[NWIN - 1];
          if (tid == 0) *reinterpret_cast<uint2*>(buf + LEAD - 8) = make_uint2(w[0], w[1]);
          su::data_sync<THREADS>();
          const unsigned long long key =
              su::data_min64<THREADS>(su::exact_key<WORDS>(buf + LEAD, s, length), s_key);
          if (key != su::NO_EVENT) {
            const int before = su::marked_before(km, s, (long long)(key >> 8));
            own = su::triple(tile_cnt, su::data_sum<THREADS>(before, s_scan), key);
          }
        }
        if (tid == 0) {  // publish; hand tile i to the look-back warp
          su::publish_aggregate(lb, t, own);
          s_own[i & 1] = own;
          s_own_tile[i & 1] = t;
          __threadfence_block();
          s_own_seq = i + 1;
        }
        // 5. the words, one shared-memory write each (the staged bytes, if
        // any, were read before data_min64's barriers)
        uint32_t* const s_u = reinterpret_cast<uint32_t*>(buf) + slot;
        runs = !flagged && !__any_sync(su::FULL, holds_lead4(w));
        if (runs)
          decode_runs(w, s_u);
        else
          decode_leads(w, km, s_u);
        if (tid == 0) s_tile = next;
      } else if (tid == 0) {  // hand the end to the look-back warp
        s_own_tile[i & 1] = nt;
        __threadfence_block();
        s_own_seq = i + 1;
      }
      // the staged words, the warps that accumulated and the next claim;
      // then the next tile's loads
      const int accumulated = su::data_sync_count<THREADS>(runs && lane == 0);
      if (live && tid == 0) lb.extra[t].x = accumulated;
      const int tn = live ? s_tile : nt;
      if (tn < nt)
        full = su::load_window<WORDS>(b, (long long)tn * TILE + tid * PER, length, vec_in, w);

      // 6. the previous tile, once its prefix is in: its words at
      // out[base ..], and the zeros past its bound on the total (its
      // inclusive count plus its in-range bytes after it) up to the
      // previous tile's bound
      if (i > 0) {
        while (s_excl_seq < i) __nanosleep(20);
        __threadfence_block();
        const long long base = s_excl[(i - 1) & 1].count;
        const uint32_t* pu = reinterpret_cast<const uint32_t*>(smem + ((i - 1) & 1) * STAGE);
        const int sh = (int)(base & 3);
        uint32_t* dst = out + (base - sh);
        for (int c = tid; c * 4 < sh + prev_cnt; c += THREADS) {
          const int u0 = c * 4 - sh;  // staged index of the chunk's first word
          if (vec_out && u0 >= 0 && u0 + 4 <= prev_cnt) {
            // the aligned staged chunk and the one before, shifted by the
            // chunk's word phase (the same for the whole tile)
            const uint4 q = reinterpret_cast<const uint4*>(pu)[c];
            const uint4 p = sh ? reinterpret_cast<const uint4*>(pu)[c - 1] : q;
            __stcs(reinterpret_cast<uint4*>(dst + c * 4),
                   sh == 0   ? q
                   : sh == 1 ? make_uint4(p.w, q.x, q.y, q.z)
                   : sh == 2 ? make_uint4(p.z, p.w, q.x, q.y)
                             : make_uint4(p.y, p.z, p.w, q.x));
          } else {
            for (int m = u0 < 0 ? 0 : u0; m < u0 + 4 && m < prev_cnt; ++m) out[base + m] = pu[m];
          }
        }
        const long long after = length - (long long)(prev_t + 1) * TILE;
        const long long from = length - (long long)prev_t * TILE;
        su::data_zero<THREADS>(reinterpret_cast<uint8_t*>(out),
                               4 * (base + prev_cnt + (after > 0 ? after : 0)),
                               4 * (base + from));
      }
      if (!live) break;
      prev_t = t, prev_cnt = tile_cnt;
      t = tn;
    }
  }

  // the zeros past `length`, which no tile's bound reaches
  su::zero_share(reinterpret_cast<uint8_t*>(out), 4 * length, 4 * n, blockIdx.x, gridDim.x);
}

}  // namespace

// One launch over nt = ceil(length / TILE) tiles (nt >= 1): out (int32[n])
// gets the word of every in-range lead, zero from total on; res (int64[4])
// = total, err_pos (BIG when valid), err_code (0), err_len (0); *err_any =
// err_pos != BIG. `scratch` holds 16 + 48 nt bytes (lookback.cuh); its head
// is cleared here on `stream` first; each tile's first extra word gets the
// warps that took the accumulating decode. `blocks` > 0 caps the grid (the
// tests run every tile through one block); 0 takes as many as are
// resident at once. Returns cudaGetLastError().
extern "C" int compose32_grid(const uint8_t* b, long long n, long long length, int nt,
                              int blocks, void* scratch, uint32_t* out, long long* res,
                              uint8_t* err_any, void* stream) {
  constexpr int SMEM = 2 * STAGE;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = su::lookback_reset(scratch, nt, st);
  if (rc != 0) return rc;
  static int cap = 0;
  if (cap == 0) {
    cudaFuncSetAttribute(compose32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cap = su::resident_blocks(compose32_kernel, ALL, SMEM);
  }
  const long long zero_blocks = (4 * n + 65535) / 65536;
  const long long want = nt > zero_blocks ? nt : zero_blocks;
  int grid = want < cap ? (int)want : cap;
  if (blocks > 0 && blocks < grid) grid = blocks;
  compose32_kernel<<<grid, ALL, SMEM, st>>>(
      b, n, length, nt, su::lookback_carve(scratch, nt), out, res, err_any);
  return (int)cudaGetLastError();
}

// compose32_grid on as many blocks as are resident at once.
extern "C" int compose32(const uint8_t* b, long long n, long long length,
                         int nt, void* scratch, uint32_t* out, long long* res,
                         uint8_t* err_any, void* stream) {
  return compose32_grid(b, n, length, nt, 0, scratch, out, res, err_any, stream);
}
