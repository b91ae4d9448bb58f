// Hopper's 1-D bulk copies between global and shared memory (the copy
// engine behind TMA), shared by the tiled kernels widen32
// (transcode32.cu) and narrow3 (transcode.cu). One thread starts a copy of
// a whole tile; the hardware computes the addresses and, for a load,
// reports completion on an mbarrier in shared memory, so no thread spends
// registers or instructions on the bytes in flight.
//
// tile_ring is the loop both kernels run over their whole tiles: a ring of
// stages in shared memory, each an input tile and an output tile; thread 0
// keeps the next stages' input loads in flight and stores each output tile
// with one evict-first bulk copy; the block's threads turn the input tile
// into the output tile in between.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace su {

// cp.async.bulk's L2 cache-policy operand for "evict first" (CUTLASS's
// CacheHintSm90::EVICT_FIRST): output streamed once and never read back
constexpr unsigned long long EVICT_FIRST = 0x12F0000000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: the barrier expects `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the barriers are initialised, before any thread or copy uses them
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(const uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory, counted on ``bar``, which expects them
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// every thread that wrote shared memory a bulk store will read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from shared
// to global memory as one bulk group, evict-first in L2
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes), "l"(EVICT_FIRST)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the thread that made the stores: wait until at most N of its bulk
// stores have yet to read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the thread that made the stores: wait until all of its bulk stores are
// complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The whole tiles of a persistent block, tile g = blockIdx.x + j *
// gridDim.x < ntiles for j = 0, 1, ...: tile g's IN input bytes at in + g *
// IN, its OUT output bytes at out + g * OUT (all 16-byte aligned, IN and
// OUT multiples of 16, OUT of 16 * THREADS), its first element `live` - g *
// TILE elements before the length. `smem` holds S * (IN + OUT) bytes. A
// tile with elements in range is loaded, and body(input tile, output tile,
// live) writes its output tile and returns the thread's flag (live: the
// tile's elements before the length, TILE or more but in the tile that
// holds the length); a tile wholly past the length loads nothing and
// stores zeros. Returns the OR of the thread's flags.
//
// Tiles with input come first, so stage s's barrier completes once for
// each of the block's tiles j with input that use it, in phase (j / S) & 1.
// Before a stage's output tile is written again, the bulk store of S tiles
// before has read it: thread 0 lets at most S - 2 stores be unread before
// the barrier that precedes the next tile's writes.
template <int S, int TILE, int IN, int OUT, int THREADS, typename Body>
__device__ __forceinline__ bool tile_ring(const uint8_t* __restrict__ in,
                                          uint8_t* __restrict__ out,
                                          long long ntiles, long long live,
                                          uint8_t* smem, Body body) {
  static_assert(S >= 2 && IN % 16 == 0 && OUT % (16 * THREADS) == 0, "tile shape");
  __shared__ uint64_t full[S];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();
  uint8_t* const in_s = smem;            // S input tiles
  uint8_t* const out_s = smem + S * IN;  // S output tiles
  // thread 0: the input of the block's j-th tile, if it has any in range
  auto fetch = [&](long long j) {
    const long long g = blockIdx.x + j * gridDim.x;
    if (g < ntiles && g * TILE < live) {
      const int s = (int)(j % S);
      bulk_load(in_s + s * IN, in + g * IN, IN, &full[s]);
    }
  };
  if (tid == 0)
    for (int j = 0; j < S; ++j) fetch(j);
  bool bad = false;
  for (long long j = 0;; ++j) {
    const long long g = blockIdx.x + j * gridDim.x;
    if (g >= ntiles) break;
    const int s = (int)(j % S);
    uint8_t* const ot = out_s + s * OUT;
    const long long left = live - g * TILE;
    if (left > 0) {
      mbar_wait(&full[s], (int)((j / S) & 1));
      bad |= body(in_s + s * IN, ot, left);
    } else {
#pragma unroll
      for (int r = 0; r < OUT / (16 * THREADS); ++r)
        reinterpret_cast<uint4*>(ot)[r * THREADS + tid] = make_uint4(0, 0, 0, 0);
    }
    // the shared stores, seen by the copy engine; the next stage's output
    // tile read out by its last copy
    fence_proxy_async();
    if (tid == 0) bulk_wait_read<S - 2>();
    __syncthreads();
    if (tid == 0) {
      bulk_store(out + g * OUT, ot, OUT);
      fetch(j + S);
    }
  }
  if (tid == 0) bulk_wait_all();
  return bad;
}

}  // namespace su
