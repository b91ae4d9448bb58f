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
//     units before it, in the same launch; valid text does no 64-bit min.
//     The window, the marks, the check and the exact path are
//     utf8_tile.cuh's, shared with compose32.cu;
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
#include "utf8_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int PER = 64;                    // bytes a thread
constexpr int WORDS = PER / 4;             // 16
constexpr int TILE = THREADS * PER;        // = kernels/compose16.TILE
constexpr int NWIN = WORDS + 3;            // window words (utf8_tile.cuh)

// The unit of the kept byte at tile offset r (s_w holds the tile's bytes
// from its start, zero past `length`, and 4 bytes after its end; `a4` says
// the byte before r is a 4-byte lead), branch-free: the lead's code point
// (su::lead_cp), its high surrogate above 0xFFFF, and the byte after a
// 4-byte lead its low surrogate.
template <bool BE>
__device__ __forceinline__ uint32_t unit_of(const uint32_t* s_w, int r, bool a4) {
  const uint32_t X = su::window_at(s_w, r);
  const uint32_t cp = su::lead_cp(X);
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
    const bool full = su::load_window<WORDS>(b, s, length, vec_in, w);
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
    int cnt;
    const uint32_t flag = su::mark_and_check<WORDS, true>(w, s, length, n, full, km, &cnt);

    int tile_cnt;
    int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_cnt);
    su::Triple own = su::triple(tile_cnt, tile_cnt, su::NO_EVENT);
    if (__syncthreads_or(flag != 0))  // exact key of the lattice, units before it
      own = su::exact_triple<NW, WORDS>(s_b, s, length, km, tile_cnt, s_key, s_scan);
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
