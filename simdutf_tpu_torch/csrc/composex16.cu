// utf16_to_utf32_compose: the _kernel_u16_to_u32 body of
// simdutf_tpu/kernels/butterflyx._run_phase_b, with the word placement of
// butterfly32._phase_c32 that butterflyx.u16_to_utf32_compose reuses, as two
// launches with a little torch glue between them.
//
// One block per tile of 2048 units (256 threads x 8, with one unit of
// look-behind and one of look-ahead, so a pair straddling a tile edge is
// seen by both tiles). A start is an in-range unit that is not a low
// surrogate; it emits one word. Count pass: the tile's starts, its first
// lone surrogate (pos << 8 | SURROGATE) and the starts before it. Emit
// pass: block-scan the starts, stage the words in shared memory, write them
// at the tile's offset.
//
// On any error the TPU butterfly raises err_any and its caller
// (ops/utf16.to_utf32) reruns the scatter engine, so the contract is that
// engine's final buffer: every start is emitted through the total, valid or
// not, and nothing is zeroed past out_len. A high surrogate emits
// ((hi - 0xD800) << 10) + (next - 0xDC00) + 0x10000 whatever the next unit
// is (0 at/after the length); a lone low emits nothing.
//
// Floor: HBM bytes, two reads of the units (count and emit passes) and one
// write of the words. The TPU compacts candidate planes with roll/select
// butterflies because its scatter was slow; here a block scan gives each
// start its slot, and shared-memory staging makes the stores contiguous.
// (The UTF-32 -> UTF-16 direction is in composex.cu, on the emitx.cuh
// skeleton: its elements need no neighbours.)
#include "utf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr long long TILE = THREADS * 8;  // units; = kernels/composex.TILE

// bit j set: unit p0 + j is an in-range start (u is load_units10's window)
__device__ __forceinline__ unsigned starts16(const int u[10], long long p0,
                                             long long length) {
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    keep |= (unsigned)(p0 + j < length && !su::is_lo(u[1 + j])) << j;
  return keep;
}

__global__ void __launch_bounds__(THREADS)
    count_kernel(const uint16_t* __restrict__ w, long long length, int be,
                 int* __restrict__ counts, unsigned long long* __restrict__ keys,
                 int* __restrict__ prefix) {
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_sum[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 8;
  int u[10];
  su::load_units10(w, p0, length, su::aligned16(w), be, u);
  const unsigned keep = starts16(u, p0, length);
  unsigned long long key = su::NO_EVENT;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (p0 + j < length && key == su::NO_EVENT && su::lone(u[j], u[1 + j], u[2 + j]))
      key = ((unsigned long long)(p0 + j) << 8) | su::SURROGATE;
  key = su::block_min_u64<NW>(key, s_key);
  const int cnt = su::block_sum<NW>(__popc(keep), s_sum);
  // starts of this thread's units strictly before the tile's first event
  const long long epos = (long long)(key >> 8);
  const unsigned before =
      epos <= p0 ? 0u : (epos >= p0 + 8 ? 0xFFu : (1u << (epos - p0)) - 1u);
  const int pre = su::block_sum<NW>(__popc(keep & before), s_sum);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = cnt;
    keys[blockIdx.x] = key;
    prefix[blockIdx.x] = pre;
  }
}

__global__ void __launch_bounds__(THREADS)
    emit_kernel(const uint16_t* __restrict__ w, long long length, int be,
                const long long* __restrict__ off, int* __restrict__ out) {
  __shared__ int s_words[TILE];
  __shared__ int s_scan[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 8;
  int u[10];
  su::load_units10(w, p0, length, su::aligned16(w), be, u);
  const unsigned keep = starts16(u, p0, length);
  int tile_words;
  int slot = su::block_excl_scan<NW>(__popc(keep), s_scan, &tile_words);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!(keep >> j & 1)) continue;
    const int x = u[1 + j];
    s_words[slot++] =
        su::is_hi(x) ? ((x - 0xD800) << 10) + (u[2 + j] - 0xDC00) + 0x10000 : x;
  }
  __syncthreads();
  const long long base = off[blockIdx.x];
  for (int i = threadIdx.x; i < tile_words; i += THREADS) out[base + i] = s_words[i];
}

}  // namespace

// Count pass over nt = ceil(length / TILE) tiles: per tile the starts, the
// first lone-surrogate key (BIG << 8 when none) and the starts before it.
// Returns cudaGetLastError().
extern "C" int u16_to_u32_count(const uint16_t* w, long long length, int be,
                                int nt, int* counts, unsigned long long* keys,
                                int* prefix, void* stream) {
  count_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(w, length, be, counts,
                                                         keys, prefix);
  return (int)cudaGetLastError();
}

// Emit pass: tile t's words go to out[off[t] + i]; the rest of `out` is left
// as the caller zeroed it.
extern "C" int u16_to_u32_emit(const uint16_t* w, long long length, int be,
                               int nt, const long long* off, int* out,
                               void* stream) {
  emit_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(w, length, be, off, out);
  return (int)cudaGetLastError();
}
