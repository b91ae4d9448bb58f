// utf8_to_utf32_compose: the general (mixed-script) validating UTF-8 ->
// UTF-32 transcode in one launch (replaces the Pallas kernels _phase_b32
// and _phase_c32 behind simdutf_tpu/kernels/butterfly32.to_utf32_compose).
//
// A persistent grid walks 16 KiB tiles (256 threads x 64 bytes) in the
// order of a global tile counter (lookback.cuh), as compose16.cu does. For
// each tile a block:
//  1. reads its bytes once: 64 a thread in four 16-byte loads, with 8 bytes
//     of halo before and 4 after, and stages them in shared memory;
//  2. marks the in-range leads (every byte that is not a continuation: one
//     word each, F8-FF included) and counts them, four bytes at a time;
//  3. runs the fast check of utf8_tile.cuh, which may flag valid text but
//     never misses an event of utf8.cuh's event_key lattice; only a tile
//     the check flags computes the exact key and the words before it;
//  4. stages the tile offsets of its leads in order (two bytes each) and
//     publishes (words, least key, words before it), then warp 0 looks
//     back for the exclusive prefix: the tile's output offset;
//  5. stores its words as aligned 16-byte chunks at that offset, each
//     thread decoding the four leads of its chunk branch-free
//     (su::lead_cp: 0 for F8-FF, a cut sequence reads the zero bytes past
//     `length`) from the staged bytes on the way out.
// Every lead writes its word, past the first error too, on valid and
// invalid input alike: the JAX package's UTF-32 engine
// (ops/utf8._to_utf32_general) leaves the decoded rest of the buffer in
// place past out_len, and the TPU butterfly's err_any rerun of it gives the
// same final buffer. Once the tiles are spent, each block waits for the
// last tile's inclusive value and zeroes its share of the output past the
// total, so the wrapper needs no fill. The last tile writes total,
// err_pos, err_code, err_len and err_any.
//
// Floor: HBM bytes, one read of the input and one write of the whole int32
// output (4 bytes a byte of input: the output is 80% of the traffic). Words
// are decoded from their staged offsets at the store rather than staged
// themselves: a tile's words would take 64 KiB of shared memory and cut the
// blocks a SM from four to two; the offsets take 32 KiB, as compose16's.
#include "utf8_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int PER = 64;                    // bytes a thread
constexpr int WORDS = PER / 4;             // 16
constexpr int TILE = THREADS * PER;        // = kernels/compose32.TILE
constexpr int NWIN = WORDS + 3;            // window words (utf8_tile.cuh)

// shared memory of a block: the tile's bytes (with 16 before and after),
// then one uint16 a lead (its tile offset)
constexpr int LEAD = 16;  // staged bytes before the tile (8 used), keeping s_w aligned
constexpr int SMEM_BYTES = LEAD + TILE + 16;
constexpr int SMEM = SMEM_BYTES + 2 * TILE + 16;  // (a word read past the last offset)

// the word of the lead at tile offset r
__device__ __forceinline__ uint32_t word_of(const uint32_t* s_w, int r) {
  return su::lead_cp(su::window_at(s_w, r));
}

__global__ void __launch_bounds__(THREADS, 4)
    compose32_kernel(const uint8_t* __restrict__ b, long long n,
                     long long length, int nt, su::Lookback lb,
                     uint32_t* __restrict__ out, long long* __restrict__ res,
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

    // 1. the window, and the tile's bytes for the decode
    uint32_t w[NWIN];
    const bool full = su::load_window<WORDS>(b, s, length, vec_in, w);
#pragma unroll
    for (int k = 0; k < WORDS / 4; ++k)
      *reinterpret_cast<uint4*>(s_w + tid * WORDS + 4 * k) =
          make_uint4(w[2 + 4 * k], w[3 + 4 * k], w[4 + 4 * k], w[5 + 4 * k]);
    if (tid == THREADS - 1) s_w[THREADS * WORDS] = w[NWIN - 1];
    if (tid == 0) *reinterpret_cast<uint2*>(smem + LEAD - 8) = make_uint2(w[0], w[1]);

    // 2-3. the leads (bit 7 of each byte) and the fast check
    uint32_t km[WORDS];
    int cnt;
    const uint32_t flag = su::mark_and_check<WORDS, false, THREADS>(w, s, length, n, full, km, &cnt);
    int tile_cnt;
    int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_cnt);
    su::Triple own = su::triple(tile_cnt, tile_cnt, su::NO_EVENT);
    if (__syncthreads_or(flag != 0))  // exact key of the lattice, words before it
      own = su::exact_triple<NW, WORDS>(s_b, s, length, km, tile_cnt, s_key, s_scan);

    // 4. the leads' offsets, in order; publish, and look back
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (km[j >> 2] >> (8 * (j & 3) + 7) & 1) s_u[slot++] = (uint16_t)(tid * PER + j);
    if (tid < 32) {
      if (tid == 0) su::publish_aggregate(lb, t, own);
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
    }
    __syncthreads();

    // 5. words [0, tile_cnt) at out[base ..] as aligned 16-byte chunks
    const long long base = s_excl.count;
    const int sh = (int)(base & 3);
    uint32_t* dst = out + (base - sh);
    const int end = sh + tile_cnt;
    for (int c = tid; c * 4 < end; c += THREADS) {
      const int u0 = c * 4 - sh;  // shared index of the chunk's first lead
      if (vec_out && u0 >= 0 && u0 + 4 <= tile_cnt) {
        // three aligned words of s_u, shifted by the chunk's offset phase
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(s_u) + (u0 >> 1);
        const int ph = 16 * (u0 & 1);
        const uint32_t q0 = sw[0], q1 = sw[1], q2 = sw[2];
        const uint32_t o01 = __funnelshift_r(q0, q1, ph), o23 = __funnelshift_r(q1, q2, ph);
        __stcs(reinterpret_cast<uint4*>(dst + c * 4),
               make_uint4(word_of(s_w, o01 & 0xFFFF), word_of(s_w, o01 >> 16),
                          word_of(s_w, o23 & 0xFFFF), word_of(s_w, o23 >> 16)));
      } else {
        for (int i = u0 < 0 ? 0 : u0; i < u0 + 4 && i < tile_cnt; ++i)
          out[base + i] = word_of(s_w, s_u[i]);
      }
    }
    // the next tile's barriers keep s_w and s_u until every store has read them
  }

  // the zero tail past the total
  const su::Triple last = su::block_wait_inclusive(lb, nt - 1, &s_excl);
  su::zero_share(reinterpret_cast<uint8_t*>(out), 4 * (long long)last.count, 4 * n,
                 blockIdx.x, gridDim.x);
}

}  // namespace

// One launch over nt = ceil(length / TILE) tiles (nt >= 1): out (int32[n])
// gets the word of every in-range lead, zero from total on; res (int64[4])
// = total, err_pos (BIG when valid), err_code (0), err_len (0); *err_any =
// err_pos != BIG. `scratch` holds 16 + 48 nt bytes (lookback.cuh); its head
// is cleared here on `stream` first. Returns cudaGetLastError().
extern "C" int compose32(const uint8_t* b, long long n, long long length,
                         int nt, void* scratch, uint32_t* out, long long* res,
                         uint8_t* err_any, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = su::lookback_reset(scratch, nt, st);
  if (rc != 0) return rc;
  static int cap = 0;
  if (cap == 0) {
    cudaFuncSetAttribute(compose32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cap = su::resident_blocks(compose32_kernel, THREADS, SMEM);
  }
  const long long zero_blocks = (4 * n + 65535) / 65536;
  const long long want = nt > zero_blocks ? nt : zero_blocks;
  const int grid = want < cap ? (int)want : cap;
  compose32_kernel<<<grid, THREADS, SMEM, st>>>(
      b, n, length, nt, su::lookback_carve(scratch, nt), out, res, err_any);
  return (int)cudaGetLastError();
}
