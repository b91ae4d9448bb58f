// utf16_to_utf8_compose: the general (mixed-width) UTF-16LE/BE -> UTF-8
// transcode, as two launches with a little torch glue between them
// (replaces the Pallas kernels _phase_b16_kernel and _phase_c16_kernel
// behind simdutf_tpu/kernels/butterfly16.to_utf8_compose), in two modes.
//
// Validating mode (VALID = false), the butterfly's accounting: each
// in-range unit emits 1, 2 or 3 bytes, and every surrogate 2, paired or
// not, so the total equals the "utf8len" count on any input; the count
// pass also reduces the tile's least event key (pos << 8 | SURROGATE, the
// first lone surrogate) and the bytes before that event, and the emit pass
// writes no byte at or after the valid prefix's end.
// Valid-only mode (VALID = true), the accounting of the JAX package's
// convert_valid scatter engine (ops/utf16._codepoints, _utf8_widths,
// _emit_utf8): a high surrogate makes a code point with the next unit,
// whatever that unit is (0 at/after the length, read through the one-unit
// halo), a low surrogate writes nothing, every other unit its own code
// point; each code point takes 1-4 bytes by its value, no event is
// reported and nothing is clamped but the buffer's end (a run of lone highs
// can ask for 4 bytes per unit, more than the 3N-byte buffer holds).
//
// Count pass, one block per tile of 2048 units: the tile's byte count (and
// in the validating mode its event key and prefix). Emit pass, one block
// per tile: recompute each unit's bytes, block-scan the byte counts, stage
// the tile's bytes in shared memory, and write them at the tile's exclusive
// offset, below min(out_len, cap).
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

// valid-only mode: the code point a start unit x makes with the unit after
// it, and its UTF-8 width (0 for a low surrogate, which starts nothing)
__device__ __forceinline__ int valid_cp(int x, int nxt) {
  return su::is_hi(x) ? ((x - 0xD800) << 10) + (nxt - 0xDC00) + 0x10000 : x;
}
__device__ __forceinline__ int valid_width(int x, int nxt) {
  if (su::is_lo(x)) return 0;
  const int cp = valid_cp(x, nxt);
  return 1 + (cp > 0x7F) + (cp > 0x7FF) + (cp > 0xFFFF);
}

template <bool VALID>
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
    if (VALID) {
      eg[j] = in_r ? valid_width(u[1 + j], u[2 + j]) : 0;
    } else {
      eg[j] = in_r ? su::utf8_bytes(u[1 + j]) : 0;
      if (in_r && key == su::NO_EVENT && su::lone(u[j], u[1 + j], u[2 + j]))
        key = ((unsigned long long)(p0 + j) << 8) | su::SURROGATE;
    }
    cnt += eg[j];
  }
  const int tile_cnt = su::block_sum<NW>(cnt, s_sum);
  if (VALID) {
    if (threadIdx.x == 0) {
      counts[blockIdx.x] = tile_cnt;
      keys[blockIdx.x] = su::NO_EVENT;
      prefix[blockIdx.x] = 0;
    }
    return;
  }
  key = su::block_min_u64<NW>(key, s_key);
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

template <bool VALID>
__global__ void __launch_bounds__(THREADS)
    emit_kernel(const uint16_t* __restrict__ w, long long length, int be,
                const long long* __restrict__ off,
                const long long* __restrict__ out_len, long long cap,
                uint8_t* __restrict__ out) {
  __shared__ uint8_t s_bytes[TILE * (VALID ? 4 : 3)];
  __shared__ int s_scan[NW];
  const long long p0 = blockIdx.x * TILE + threadIdx.x * 8;
  int u[10];
  su::load_units10(w, p0, length, su::aligned16(w), be, u);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    cnt += p0 + j >= length ? 0
           : VALID         ? valid_width(u[1 + j], u[2 + j])
                           : su::utf8_bytes(u[1 + j]);
  int tile_bytes;
  int slot = su::block_excl_scan<NW>(cnt, s_scan, &tile_bytes);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (p0 + j >= length) break;
    const int x = u[1 + j];
    uint8_t* d = s_bytes + slot;
    if (VALID) {
      const int cp = valid_cp(x, u[2 + j]);
      const int wd = valid_width(x, u[2 + j]);
      if (wd == 1) {
        d[0] = cp;
      } else if (wd == 2) {
        d[0] = 0xC0 | (cp >> 6);
        d[1] = 0x80 | (cp & 0x3F);
      } else if (wd == 3) {
        d[0] = 0xE0 | (cp >> 12);
        d[1] = 0x80 | ((cp >> 6) & 0x3F);
        d[2] = 0x80 | (cp & 0x3F);
      } else if (wd == 4) {
        d[0] = 0xF0 | (cp >> 18);
        d[1] = 0x80 | ((cp >> 12) & 0x3F);
        d[2] = 0x80 | ((cp >> 6) & 0x3F);
        d[3] = 0x80 | (cp & 0x3F);
      }
      slot += wd;
    } else if (x < 0x80) {
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
  const long long lim = *out_len < cap ? *out_len : cap;
  for (int i = threadIdx.x; i < tile_bytes; i += THREADS) {
    const long long g = base + i;
    if (g < lim) out[g] = s_bytes[i];
  }
}

}  // namespace

// Count pass over nt = ceil(length / TILE) tiles: per tile the byte count,
// the least event key (BIG << 8 when none, and always in the valid-only
// mode) and the bytes before that event. Returns cudaGetLastError().
extern "C" int compose8_count(const uint16_t* w, long long length, int be,
                              int valid, int nt, int* counts,
                              unsigned long long* keys, int* prefix,
                              void* stream) {
  if (valid)
    count_kernel<true><<<nt, THREADS, 0, (cudaStream_t)stream>>>(
        w, length, be, counts, keys, prefix);
  else
    count_kernel<false><<<nt, THREADS, 0, (cudaStream_t)stream>>>(
        w, length, be, counts, keys, prefix);
  return (int)cudaGetLastError();
}

// Emit pass: tile t's bytes go to out[off[t] + i] while that index is below
// *out_len and below cap (the buffer's size); the rest of `out` is left as
// the caller zeroed it.
extern "C" int compose8_emit(const uint16_t* w, long long length, int be,
                             int valid, int nt, const long long* off,
                             const long long* out_len, long long cap,
                             uint8_t* out, void* stream) {
  if (valid)
    emit_kernel<true><<<nt, THREADS, 0, (cudaStream_t)stream>>>(
        w, length, be, off, out_len, cap, out);
  else
    emit_kernel<false><<<nt, THREADS, 0, (cudaStream_t)stream>>>(
        w, length, be, off, out_len, cap, out);
  return (int)cudaGetLastError();
}
