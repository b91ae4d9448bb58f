// The skeleton shared by the compose kernels that emit a variable number of
// output units from each fixed-width input element (composex.cu: UTF-32
// words and Latin-1 bytes to UTF-8 bytes, UTF-32 words to UTF-16 units), as
// two templates parametrised by the per-element emitter.
//
// Count pass, one block per tile of 2048 elements (256 threads x 8): each
// in-range element emits E::width units; the block reduces the tile's unit
// count and, for an emitter with events, its least event key and the units
// before that event. Emit pass, one block per tile: recompute each
// element's width, block-scan the widths, stage the tile's units in shared
// memory, and write them at the tile's exclusive offset. Every in-range
// element's units are written through the total, on valid and invalid
// input alike; the rest of the output is left as the caller zeroed it.
//
// An emitter E provides:
//   using Elem, Out;                     input element and output unit types
//   static constexpr int MAX_OUT;        the most units one element emits
//   static constexpr bool EVENTS;        whether an element can be invalid
//   static void load8(const Elem*, long long p0, long long length, int v[8]);
//                                        v[j] = element p0 + j, 0 at/after length
//   static int width(int v);             units of an in-range element
//   static int put(int v, Out* d);       writes those units, returns width(v)
//   static bool bad(int v);              whether v is invalid (only when
//   static int code(int v);              EVENTS) and its error code
//
// Two details keep the template as fast as the hand-written kernels it
// replaced (chip_smoke.py's breakdowns on an H100, PERF.md): bad() tested
// inside the first-event condition with the key reduced before the count
// (the other way cost the UTF-32 count passes ~9%), and a put() that
// returns its width (recomputing it cost the UTF-16 emit pass ~15%).
//
// compose8.cu and composex16.cu keep their own kernels: their elements need
// a unit of look-behind and look-ahead, and compose8's output stops at
// out_len.
#pragma once

#include "utf8.cuh"

namespace su {

constexpr int EMITX_THREADS = 256;
constexpr int EMITX_NW = EMITX_THREADS / 32;
constexpr long long EMITX_TILE = EMITX_THREADS * 8;  // elements per block

template <class E>
__global__ void __launch_bounds__(EMITX_THREADS)
    emitx_count_kernel(const typename E::Elem* __restrict__ src,
                       long long length, int* __restrict__ counts,
                       unsigned long long* __restrict__ keys,
                       int* __restrict__ prefix) {
  __shared__ unsigned long long s_key[EMITX_NW];
  __shared__ int s_sum[EMITX_NW];
  const long long p0 = blockIdx.x * EMITX_TILE + threadIdx.x * 8;
  int v[8];
  E::load8(src, p0, length, v);
  int eg[8];
  int cnt = 0;
  unsigned long long key = NO_EVENT;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in_r = p0 + j < length;
    eg[j] = in_r ? E::width(v[j]) : 0;
    cnt += eg[j];
    if constexpr (E::EVENTS) {
      if (in_r && key == NO_EVENT && E::bad(v[j]))
        key = ((unsigned long long)(p0 + j) << 8) | (unsigned)E::code(v[j]);
    }
  }
  if constexpr (E::EVENTS) key = block_min_u64<EMITX_NW>(key, s_key);
  const int tile_cnt = block_sum<EMITX_NW>(cnt, s_sum);
  if constexpr (E::EVENTS) {
    // units of this thread's elements strictly before the tile's first event
    const long long epos = (long long)(key >> 8);
    int pre = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) pre += p0 + j < epos ? eg[j] : 0;
    const int tile_pre = block_sum<EMITX_NW>(pre, s_sum);
    if (threadIdx.x == 0) {
      keys[blockIdx.x] = key;
      prefix[blockIdx.x] = tile_pre;
    }
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = tile_cnt;
}

template <class E>
__global__ void __launch_bounds__(EMITX_THREADS)
    emitx_emit_kernel(const typename E::Elem* __restrict__ src,
                      long long length, const long long* __restrict__ off,
                      typename E::Out* __restrict__ out) {
  __shared__ typename E::Out s_out[EMITX_TILE * E::MAX_OUT];
  __shared__ int s_scan[EMITX_NW];
  const long long p0 = blockIdx.x * EMITX_TILE + threadIdx.x * 8;
  int v[8];
  E::load8(src, p0, length, v);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) cnt += p0 + j < length ? E::width(v[j]) : 0;
  int tile_units;
  int slot = block_excl_scan<EMITX_NW>(cnt, s_scan, &tile_units);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (p0 + j >= length) break;
    slot += E::put(v[j], s_out + slot);
  }
  __syncthreads();
  const long long base = off[blockIdx.x];
  for (int i = threadIdx.x; i < tile_units; i += EMITX_THREADS)
    out[base + i] = s_out[i];
}

}  // namespace su
