// utf16_to_utf8_compose: the general (mixed-width) validating UTF-16LE/BE
// -> UTF-8 transcode, as two launches with a little torch glue between
// them (replaces the Pallas kernels _phase_b16_kernel and _phase_c16_kernel
// behind simdutf_tpu/kernels/butterfly16.to_utf8_compose).
//
// Count pass, one block per tile of 2048 units: each in-range unit emits
// 1, 2 or 3 bytes, and every surrogate 2, paired or not (the butterfly's
// accounting, so the total equals the "utf8len" count on any input); the
// block reduces the tile's byte count, its least event key
// (pos << 8 | SURROGATE, the first lone surrogate) and the bytes before
// that event. Emit pass, one block per tile: recompute each unit's bytes,
// block-scan the byte counts, stage the tile's bytes in shared memory, and
// write them at the tile's exclusive offset, clamped at out_len.
//
// Floor: HBM bytes, two reads of the 2-byte units (count pass and emit
// pass) and one write of the output bytes. The TPU compacts each tile with
// roll/select butterflies over four candidate byte planes because its
// scatter was slow; here a block scan gives each unit its output slot,
// and staging through shared memory turns each thread's scattered byte
// stores into contiguous warp stores.
#include "utf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr long long TILE = THREADS * 8;  // units; = kernels/compose8.TILE

__global__ void __launch_bounds__(THREADS)
    count_kernel(const uint16_t* __restrict__ w, long long length, int be,
                 int* __restrict__ counts, unsigned long long* __restrict__ keys,
                 int* __restrict__ prefix) {
  __shared__ unsigned long long s_key[NW];
  __shared__ int s_sum[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 8;
  int u[10];
  su::load_units10(w, p0, length, su::aligned16(w), be, u);
  int eg[8];
  int cnt = 0;
  unsigned long long key = su::NO_EVENT;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in_r = p0 + j < length;
    eg[j] = in_r ? su::utf8_bytes(u[1 + j]) : 0;
    cnt += eg[j];
    if (in_r && key == su::NO_EVENT && su::lone(u[j], u[1 + j], u[2 + j]))
      key = ((unsigned long long)(p0 + j) << 8) | su::SURROGATE;
  }
  key = su::block_min_u64<NW>(key, s_key);
  const int tile_cnt = su::block_sum<NW>(cnt, s_sum);
  // bytes of this thread's units strictly before the tile's first event
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
    emit_kernel(const uint16_t* __restrict__ w, long long length, int be,
                const long long* __restrict__ off,
                const long long* __restrict__ out_len,
                uint8_t* __restrict__ out) {
  __shared__ uint8_t s_bytes[TILE * 3];
  __shared__ int s_scan[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 8;
  int u[10];
  su::load_units10(w, p0, length, su::aligned16(w), be, u);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) cnt += p0 + j < length ? su::utf8_bytes(u[1 + j]) : 0;
  int tile_bytes;
  int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_bytes);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (p0 + j >= length) break;
    const int x = u[1 + j];
    uint8_t* d = s_bytes + slot;
    if (x < 0x80) {
      d[0] = x;
      slot += 1;
    } else if (x < 0x800) {
      d[0] = 0xC0 | (x >> 6);
      d[1] = 0x80 | (x & 0x3F);
      slot += 2;
    } else if (su::is_hi(x)) {  // first two bytes of the pair's 4
      const int hb = x - 0xD7C0;  // cp >> 10
      d[0] = 0xF0 | (hb >> 8);
      d[1] = 0x80 | ((hb >> 2) & 0x3F);
      slot += 2;
    } else if (su::is_lo(x)) {  // last two, with two bits of the high
      const int hb = u[j] - 0xD7C0;
      d[0] = 0x80 | ((hb & 0x3) << 4) | ((x >> 6) & 0xF);
      d[1] = 0x80 | (x & 0x3F);
      slot += 2;
    } else {
      d[0] = 0xE0 | (x >> 12);
      d[1] = 0x80 | ((x >> 6) & 0x3F);
      d[2] = 0x80 | (x & 0x3F);
      slot += 3;
    }
  }
  __syncthreads();
  const long long base = off[blockIdx.x];
  const long long lim = *out_len;
  for (int i = threadIdx.x; i < tile_bytes; i += THREADS) {
    const long long g = base + i;
    if (g < lim) out[g] = s_bytes[i];
  }
}

}  // namespace

// Count pass over nt = ceil(length / TILE) tiles: per tile the byte count,
// the least event key (BIG << 8 when none) and the bytes before that event.
// Returns cudaGetLastError().
extern "C" int compose8_count(const uint16_t* w, long long length, int be,
                              int nt, int* counts, unsigned long long* keys,
                              int* prefix, void* stream) {
  count_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(w, length, be, counts,
                                                         keys, prefix);
  return (int)cudaGetLastError();
}

// Emit pass: tile t's bytes go to out[off[t] + i] while that index is below
// *out_len; the rest of `out` is left as the caller zeroed it.
extern "C" int compose8_emit(const uint16_t* w, long long length, int be,
                             int nt, const long long* off,
                             const long long* out_len, uint8_t* out,
                             void* stream) {
  emit_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(w, length, be, off,
                                                        out_len, out);
  return (int)cudaGetLastError();
}
