// utf32_to_utf8_compose: the general (mixed-width) validating UTF-32 ->
// UTF-8 transcode, as two launches with a little torch glue between them
// (replaces the Pallas phase B driver simdutf_tpu/kernels/butterflyx
// ._run_phase_b with its _kernel_u32_to_u8 body, and the byte placement of
// butterfly16._phase_c16 that butterflyx.u32_to_utf8_compose reuses).
//
// Count pass, one block per tile of 2048 words: each in-range word emits
// 1-4 bytes as ops/utf32._emit_utf8 does (a word above 0x10FFFF emits the
// one byte 0x00, a surrogate its 3 bytes); the block reduces the tile's
// byte count, its least error key (pos << 8 | TOO_LARGE or SURROGATE) and
// the bytes before that event. Emit pass, one block per tile: recompute
// each word's bytes, block-scan the byte counts, stage the tile's bytes in
// shared memory, and write them at the tile's exclusive offset.
//
// The emit pass writes every in-range word's bytes through the total, on
// valid and invalid input alike: the JAX package's scatter engine
// (ops/utf32.to_utf8) leaves the rest of the buffer in place past out_len,
// and the TPU butterfly's err_any rerun of it gives the same final buffer;
// this one pass gives it directly. This is compose8's skeleton with a
// UTF-32 emitter.
//
// Floor: HBM bytes, two reads of the 4-byte words (count and emit passes)
// and one write of the output bytes. The TPU compacts four candidate byte
// planes per tile with roll/select butterflies because its scatter was
// slow; here a block scan gives each word its output slot, and staging in
// shared memory turns each thread's scattered byte stores into contiguous
// warp stores.
#include "utf32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr long long TILE = THREADS * 8;  // words; = kernels/composex.TILE

__global__ void __launch_bounds__(THREADS)
    count_kernel(const int* __restrict__ w, long long length,
                 int* __restrict__ counts, unsigned long long* __restrict__ keys,
                 int* __restrict__ prefix) {
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_sum[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 8;
  int u[8];
  su::load_words8(w, p0, length, su::aligned16w(w), u);
  int eg[8];
  int cnt = 0;
  unsigned long long key = su::NO_EVENT;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in_r = p0 + j < length;
    eg[j] = in_r ? su::utf8_width(su::emit_cp32(u[j])) : 0;
    cnt += eg[j];
    if (in_r && key == su::NO_EVENT && su::bad32(u[j]))
      key = ((unsigned long long)(p0 + j) << 8) |
            (su::too_large32(u[j]) ? su::TOO_LARGE : su::SURROGATE);
  }
  key = su::block_min_u64<NW>(key, s_key);
  const int tile_cnt = su::block_sum<NW>(cnt, s_sum);
  // bytes of this thread's words strictly before the tile's first event
  const long long epos = (long long)(key >> 8);
  int pre = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) pre += p0 + j < epos ? eg[j] : 0;
  const int tile_pre = su::block_sum<NW>(pre, s_sum);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = tile_cnt;
    keys[blockIdx.x] = key;
    prefix[blockIdx.x] = tile_pre;
  }
}

__global__ void __launch_bounds__(THREADS)
    emit_kernel(const int* __restrict__ w, long long length,
                const long long* __restrict__ off, uint8_t* __restrict__ out) {
  __shared__ uint8_t s_bytes[TILE * 4];
  __shared__ int s_scan[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 8;
  int u[8];
  su::load_words8(w, p0, length, su::aligned16w(w), u);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    cnt += p0 + j < length ? su::utf8_width(su::emit_cp32(u[j])) : 0;
  int tile_bytes;
  int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_bytes);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (p0 + j >= length) break;
    const int cp = su::emit_cp32(u[j]);
    uint8_t* d = s_bytes + slot;
    if (cp < 0x80) {
      d[0] = cp;
      slot += 1;
    } else if (cp < 0x800) {
      d[0] = 0xC0 | (cp >> 6);
      d[1] = 0x80 | (cp & 0x3F);
      slot += 2;
    } else if (cp < 0x10000) {
      d[0] = 0xE0 | (cp >> 12);
      d[1] = 0x80 | ((cp >> 6) & 0x3F);
      d[2] = 0x80 | (cp & 0x3F);
      slot += 3;
    } else {
      d[0] = 0xF0 | (cp >> 18);
      d[1] = 0x80 | ((cp >> 12) & 0x3F);
      d[2] = 0x80 | ((cp >> 6) & 0x3F);
      d[3] = 0x80 | (cp & 0x3F);
      slot += 4;
    }
  }
  __syncthreads();
  const long long base = off[blockIdx.x];
  for (int i = threadIdx.x; i < tile_bytes; i += THREADS) out[base + i] = s_bytes[i];
}

}  // namespace

// Count pass over nt = ceil(length / TILE) tiles: per tile the byte count,
// the least event key (BIG << 8 when none) and the bytes before that event.
// Returns cudaGetLastError().
extern "C" int composex_count(const int* w, long long length, int nt,
                              int* counts, unsigned long long* keys,
                              int* prefix, void* stream) {
  count_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(w, length, counts,
                                                         keys, prefix);
  return (int)cudaGetLastError();
}

// Emit pass: tile t's bytes go to out[off[t] + i]; the rest of `out` is
// left as the caller zeroed it.
extern "C" int composex_emit(const int* w, long long length, int nt,
                             const long long* off, uint8_t* out,
                             void* stream) {
  emit_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(w, length, off, out);
  return (int)cudaGetLastError();
}
