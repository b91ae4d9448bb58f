// utf8_to_utf16_compose: the general (mixed-script) validating UTF-8 ->
// UTF-16LE/BE transcode, as two launches with a little torch glue between
// them (replaces the Pallas kernels _phase_b_kernel and _phase_c_kernel
// behind simdutf_tpu/kernels/butterfly.to_utf16_compose).
//
// Count pass, one block per 4 KiB tile: each byte keeps a unit when it is
// an in-range lead or the byte after a 4-byte lead (the unit-per-byte form
// of ops/utf8._emit_utf16_units); the block reduces the tile's unit count,
// its minimum error key (pos << 8 | code) and the units before that event.
// Emit pass, one block per tile: recompute the units, block-scan the keep
// counts, stage the tile's units in shared memory, and write them at the
// tile's exclusive offset, clamped at out_len.
//
// Floor: HBM bytes, two reads of the input (the count pass's and the emit
// pass's) and one write of the 2-byte units; this version is bound by the
// per-byte lattice work instead (PERF.md). The TPU compacts with
// roll/select butterflies because its scatter was slow; here a block scan
// gives each unit its slot directly, and staging through shared memory
// turns each thread's scattered unit stores into contiguous warp stores.
#include "utf8.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr long long TILE = THREADS * 16;  // = kernels/compose16.TILE

__global__ void __launch_bounds__(THREADS)
    count_kernel(const uint8_t* __restrict__ b, long long n, long long length,
                 int* __restrict__ counts, unsigned long long* __restrict__ keys,
                 int* __restrict__ prefix) {
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_sum[NW];
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 16;
  int c[24];
  su::load_window24(b, p0, length, vec, c);
  unsigned keep = 0;
  unsigned long long key = su::NO_EVENT;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long p = p0 + j;
    const int x = c[4 + j];
    const bool in_r = p < length;
    // the byte after an in-range 4-byte lead carries the low surrogate;
    // it may sit at `length` itself (a truncated sequence)
    const bool k = p < n && ((in_r && !su::is_cont(x)) || su::is_lead4(c[3 + j]));
    keep |= (unsigned)k << j;
    if (in_r) {
      const unsigned long long e = su::event_key(
          p, x, c[5 + j], c[6 + j], c[7 + j], c[3 + j], c[2 + j], c[1 + j]);
      key = e < key ? e : key;
    }
  }
  key = su::block_min_u64<NW>(key, s_key);
  const int cnt = su::block_sum<NW>(__popc(keep), s_sum);
  // units of this thread's bytes strictly before the tile's first event
  const long long epos = (long long)(key >> 8);
  const unsigned before =
      epos <= p0 ? 0u : (epos >= p0 + 16 ? 0xFFFFu : (1u << (epos - p0)) - 1u);
  const int pre = su::block_sum<NW>(__popc(keep & before), s_sum);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = cnt;
    keys[blockIdx.x] = key;
    prefix[blockIdx.x] = pre;
  }
}

__global__ void __launch_bounds__(THREADS)
    emit_kernel(const uint8_t* __restrict__ b, long long n, long long length,
                int big_endian, const long long* __restrict__ off,
                const long long* __restrict__ out_len,
                uint16_t* __restrict__ out) {
  __shared__ uint16_t s_units[TILE];
  __shared__ int s_scan[NW];
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 16;
  int c[24];
  su::load_window24(b, p0, length, vec, c);
  unsigned keep = 0;
  uint16_t u[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long p = p0 + j;
    const int x = c[4 + j];
    const bool after4 = su::is_lead4(c[3 + j]);
    const bool k = p < n && ((p < length && !su::is_cont(x)) || after4);
    keep |= (unsigned)k << j;
    int v;
    if (after4) {  // low surrogate of the 4-byte sequence starting at p-1
      v = 0xDC00 + ((su::cp4_of(c[3 + j], x, c[5 + j], c[6 + j]) - 0x10000) & 0x3FF);
    } else {
      const int cp = su::decode_cp(x, c[5 + j], c[6 + j], c[7 + j]);
      v = cp > 0xFFFF ? 0xD800 + ((cp - 0x10000) >> 10) : cp;
    }
    if (big_endian) v = ((v << 8) | (v >> 8)) & 0xFFFF;
    u[j] = (uint16_t)v;
  }
  int tile_units;
  int slot = su::block_excl_scan<NW>(__popc(keep), s_scan, &tile_units);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (keep >> j & 1) s_units[slot++] = u[j];
  __syncthreads();
  const long long base = off[blockIdx.x];
  const long long lim = *out_len;
  for (int i = threadIdx.x; i < tile_units; i += THREADS) {
    const long long g = base + i;
    if (g < lim) out[g] = s_units[i];
  }
}

}  // namespace

// Count pass over nt = ceil(min(n, length + 1) / TILE) tiles: per tile the
// unit count, the minimum event key (BIG << 8 when none) and the units
// before that event. Returns cudaGetLastError().
extern "C" int compose16_count(const uint8_t* b, long long n, long long length,
                               int nt, int* counts, unsigned long long* keys,
                               int* prefix, void* stream) {
  count_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(b, n, length, counts,
                                                         keys, prefix);
  return (int)cudaGetLastError();
}

// Emit pass: tile t's units go to out[off[t] + i] while that index is below
// *out_len; the rest of `out` is left as the caller zeroed it.
extern "C" int compose16_emit(const uint8_t* b, long long n, long long length,
                              int nt, int big_endian, const long long* off,
                              const long long* out_len, uint16_t* out,
                              void* stream) {
  emit_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(
      b, n, length, big_endian, off, out_len, out);
  return (int)cudaGetLastError();
}
