// utf8_to_utf32_compose: the general (mixed-script) validating UTF-8 ->
// UTF-32 transcode, as two launches with a little torch glue between them
// (replaces the Pallas kernels _phase_b32_kernel and _phase_c32_kernel
// behind simdutf_tpu/kernels/butterfly32.to_utf32_compose).
//
// Count pass, one block per 4 KiB tile: each in-range lead (a byte that is
// not a continuation) emits one word; the block reduces the tile's word
// count, its least error key (pos << 8 | code, the UTF-8 lattice of
// utf8.cuh) and the words before that event. Emit pass, one block per
// tile: recompute the leads and their mechanically decoded code points
// (ops/utf8.classify's ``cp``: 0 for F8..FF, partial sequences read zeros
// past the length), block-scan the lead counts, stage the tile's words in
// shared memory, and write them at the tile's exclusive offset.
//
// Unlike compose16, the emit pass writes every lead's word through the
// total, on valid and invalid input alike: the JAX package's UTF-32 engine
// (ops/utf8._to_utf32_general) leaves the decoded rest of the buffer in
// place past out_len, and the TPU butterfly's err_any rerun of it gives the
// same final buffer; this one pass gives it directly.
//
// Floor: HBM bytes, two reads of the input (count and emit passes) and one
// write of the 4-byte words. The TPU compacts with roll/select butterflies
// because its scatter was slow; here a block scan gives each word its slot
// and shared-memory staging turns each thread's scattered word stores into
// contiguous warp stores.
#include "utf8.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr long long TILE = THREADS * 16;  // bytes; = kernels/compose32.TILE

__global__ void __launch_bounds__(THREADS)
    count_kernel(const uint8_t* __restrict__ b, long long length,
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
    if (p < length) {
      keep |= (unsigned)!su::is_cont(x) << j;
      const unsigned long long e = su::event_key(
          p, x, c[5 + j], c[6 + j], c[7 + j], c[3 + j], c[2 + j], c[1 + j]);
      key = e < key ? e : key;
    }
  }
  key = su::block_min_u64<NW>(key, s_key);
  const int cnt = su::block_sum<NW>(__popc(keep), s_sum);
  // leads of this thread's bytes strictly before the tile's first event
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
    emit_kernel(const uint8_t* __restrict__ b, long long length,
                const long long* __restrict__ off, int* __restrict__ out) {
  __shared__ int s_words[TILE];
  __shared__ int s_scan[NW];
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 16;
  int c[24];
  su::load_window24(b, p0, length, vec, c);
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    keep |= (unsigned)(p0 + j < length && !su::is_cont(c[4 + j])) << j;
  int tile_words;
  int slot = su::block_excl_scan<NW>(__popc(keep), s_scan, &tile_words);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (keep >> j & 1)
      s_words[slot++] = su::decode_cp(c[4 + j], c[5 + j], c[6 + j], c[7 + j]);
  __syncthreads();
  const long long base = off[blockIdx.x];
  for (int i = threadIdx.x; i < tile_words; i += THREADS) out[base + i] = s_words[i];
}

}  // namespace

// Count pass over nt = ceil(length / TILE) tiles: per tile the word count,
// the least event key (BIG << 8 when none) and the words before that event.
// Returns cudaGetLastError().
extern "C" int compose32_count(const uint8_t* b, long long length, int nt,
                               int* counts, unsigned long long* keys,
                               int* prefix, void* stream) {
  count_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(b, length, counts,
                                                         keys, prefix);
  return (int)cudaGetLastError();
}

// Emit pass: tile t's words go to out[off[t] + i]; the rest of `out` is
// left as the caller zeroed it.
extern "C" int compose32_emit(const uint8_t* b, long long length, int nt,
                              const long long* off, int* out, void* stream) {
  emit_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(b, length, off, out);
  return (int)cudaGetLastError();
}
