// Single-pass tile scan with decoupled look-back, shared by the one-launch
// compaction kernels (compose16.cu's UTF-8 -> UTF-16, compose32.cu's
// UTF-8 -> UTF-32, base64.cu's b64_compact and, on the wide slots at the
// end of this header, compose8.cu's UTF-16 -> UTF-8). It takes the place
// of their count pass, the torch glue of ops/common.tile_glue and their
// emit pass: each tile reduces its own aggregate, publishes it, folds its
// predecessors' published values into its exclusive prefix (its output
// offset and whether the first error lies before it), and writes its
// output in the same launch.
//
// The aggregate is tile_glue's triple (count, least event key
// pos << 8 | code, count before that key), `before` being `count` when the
// tile has no event. Its combine, earlier tile first, is associative:
//   count  = a.count + b.count
//   key    = min(a.key, b.key)
//   before = a.key < b.key ? a.before : a.count + b.before
// Event positions of two tiles never tie, and two "no event" keys give
// a.count + b.count, so the rule holds for every pair.
//
// What a look-back kernel must get right, and how this header does it:
// * Forward progress. Tile ids come from a global atomicAdd counter taken
//   by a running block, never from blockIdx: a tile is claimed only by a
//   block that is resident, so every tile waited on belongs to a block that
//   runs, and the lowest unfinished tile waits on nothing.
// * Memory ordering. The status rides in the value's own slot. Each tile
//   has two 16-byte slots, its aggregate and its inclusive value, and each
//   slot is written exactly once, from the zeros of the reset, as two
//   64-bit halves: (count, before | 2^31) and (key | 2^63). A reader loads
//   both halves (two independent loads, one round trip) and takes the slot
//   as published only when both ready bits are set. Each half is one
//   aligned 64-bit access, which the PTX memory model makes single-copy
//   atomic, so a reader sees each half either as zero or as its final
//   value: it never takes a half-written slot for a published one, and no
//   release fence is needed between a value and its status. (count and
//   before are below 2^31 and a key below 2^39, so the bits are free.)
//   Words published beside a slot (b64_compact's last kept indices) are
//   written before a fence.acq_rel.gpu that precedes the slot, and read
//   after a fence that follows seeing it.
// * Reset without a host sync. The counter and both slot arrays lie at the
//   head of one scratch buffer that the entry point clears with one
//   cudaMemsetAsync on the caller's stream before the launch.
// * The zero tail. A block whose claim comes back past the last tile waits
//   for the last tile's inclusive value, then zeroes its share of the
//   output past the valid length. Tiles write only below that length and
//   the zeroes go only at or above it, so the two never touch the same
//   byte, and the wait is safe: the last tile was claimed by a running
//   block.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "utf8.cuh"

namespace su {

struct alignas(16) Triple {
  int count;
  int before;  // count before `key`, or `count` when key == NO_EVENT
  unsigned long long key;
};

__device__ __forceinline__ Triple triple(int count, int before,
                                         unsigned long long key) {
  Triple r;
  r.count = count;
  r.before = before;
  r.key = key;
  return r;
}

// a is the earlier of two adjacent runs of tiles
__device__ __forceinline__ Triple combine(const Triple& a, const Triple& b) {
  return triple(a.count + b.count,
                a.key < b.key ? a.before : a.count + b.before,
                a.key < b.key ? a.key : b.key);
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// a published slot: two 64-bit halves, each with its ready bit
struct alignas(16) Slot {
  unsigned long long lo;  // count | (before | 2^31) << 32
  unsigned long long hi;  // key | 2^63
};

constexpr unsigned long long READY_LO = 1ull << 63, READY_HI = 1ull << 63;

__device__ __forceinline__ void publish(Slot* s, const Triple& v) {
  st_relaxed(&s->lo, (unsigned long long)(unsigned)v.count |
                         ((unsigned long long)(unsigned)v.before << 32) | READY_LO);
  st_relaxed(&s->hi, v.key | READY_HI);
}

// loads slot s; true (and its value) when both halves are published
__device__ __forceinline__ bool peek(const Slot* s, Triple* v) {
  const unsigned long long lo = ld_relaxed(&s->lo), hi = ld_relaxed(&s->hi);
  *v = triple((int)(unsigned)lo, (int)((unsigned)(lo >> 32) & 0x7FFFFFFFu),
              hi & ~READY_HI);
  return (lo & READY_LO) && (hi & READY_HI);
}

__device__ __forceinline__ Triple shfl_down(const Triple& v, int d) {
  return triple(__shfl_down_sync(FULL, v.count, d),
                __shfl_down_sync(FULL, v.before, d),
                __shfl_down_sync(FULL, v.key, d));
}

__device__ __forceinline__ Triple shfl0(const Triple& v) {
  return triple(__shfl_sync(FULL, v.count, 0), __shfl_sync(FULL, v.before, 0),
                __shfl_sync(FULL, v.key, 0));
}

// The scratch buffer of one call, 16 + 48 nt bytes (kernels/_build.py's
// lookback_scratch allocates it), carved by lookback_carve:
//   [0, 16)              the tile counter (and padding)
//   [16, 16 + 32 nt)     the aggregate slots, then the inclusive slots
//   then                 4 extra int32 words a tile
// Only the first 16 + 32 nt bytes need clearing (lookback_reset_bytes).
struct Lookback {
  unsigned* counter;
  Slot* agg;
  Slot* incl;
  int4* extra;
};

inline long long lookback_reset_bytes(int nt) { return 16 + 32ll * nt; }

inline Lookback lookback_carve(void* scratch, int nt) {
  char* base = static_cast<char*>(scratch);
  Lookback lb;
  lb.counter = reinterpret_cast<unsigned*>(base);
  lb.agg = reinterpret_cast<Slot*>(base + 16);
  lb.incl = reinterpret_cast<Slot*>(base + 16 + 16ll * nt);
  lb.extra = reinterpret_cast<int4*>(base + 16 + 32ll * nt);
  return lb;
}

// Clears the counter and the slots on `stream`; returns the cudaError_t.
inline int lookback_reset(void* scratch, int nt, cudaStream_t stream) {
  return (int)cudaMemsetAsync(scratch, 0, (size_t)lookback_reset_bytes(nt), stream);
}

// Claim the next tile (thread 0), broadcast through `s_tile`. The caller's
// barriers keep `s_tile` from being overwritten while it is read.
__device__ __forceinline__ int claim_tile(const Lookback& lb, int* s_tile) {
  if (threadIdx.x == 0) *s_tile = (int)atomicAdd(lb.counter, 1u);
  __syncthreads();
  return *s_tile;
}

// Thread 0: publish tile t's aggregate (tile 0's is also its inclusive
// value). Extra words, if any, are written and fenced by the caller first.
__device__ __forceinline__ void publish_aggregate(const Lookback& lb, int t,
                                                  const Triple& agg) {
  if (t == 0) publish(lb.incl, agg);
  publish(lb.agg + t, agg);
}

__device__ __forceinline__ void publish_inclusive(const Lookback& lb, int t,
                                                  const Triple& incl) {
  publish(lb.incl + t, incl);
}

__device__ __forceinline__ void backoff(int* ns) {
  __nanosleep(*ns);
  if (*ns < 512) *ns *= 2;
}

// Wait (one lane) for slot s; returns its value.
__device__ __forceinline__ Triple wait_slot(const Slot* s) {
  Triple v;
  for (int ns = 32; !peek(s, &v);) backoff(&ns);
  return v;
}

// Exclusive prefix of tile t > 0, computed by one whole warp (every lane
// calls it; every lane gets the result). Lane L looks at tile j - L of a
// window of 32 (its inclusive slot, else its aggregate); the window is
// folded once every lane sees one of them, up to and including the nearest
// inclusive one; windows step back until one holds an inclusive value
// (tiles before 0 count as an inclusive identity).
__device__ __forceinline__ Triple lookback_prefix(const Lookback& lb, int t) {
  const int lane = threadIdx.x & 31;
  Triple acc = triple(0, 0, NO_EVENT);
  for (int j = t - 1;; j -= 32) {
    const int i = j - lane;
    Triple v = triple(0, 0, NO_EVENT);
    bool inc = i < 0, agg = false;
    for (int ns = 32;;) {
      if (!inc && !agg && i >= 0) {
        Triple a;
        inc = peek(lb.incl + i, &v);
        if (!inc) {
          agg = peek(lb.agg + i, &a);
          if (agg) v = a;
        }
      }
      if (__all_sync(FULL, inc || agg)) break;
      backoff(&ns);
    }
    const unsigned incl = __ballot_sync(FULL, inc);
    const int stop = __ffs(incl) - 1;  // -1: no inclusive value in the window
    if (incl && lane > stop) v = triple(0, 0, NO_EVENT);
    // ordered fold: higher lanes hold earlier tiles
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Triple o = shfl_down(v, d);
      if (lane + d < 32) v = combine(o, v);
    }
    acc = combine(shfl0(v), acc);
    if (incl) return acc;
  }
}

// Thread 0 waits for tile i's inclusive value; every thread of the block
// gets it (through `s`).
__device__ __forceinline__ Triple block_wait_inclusive(const Lookback& lb, int i,
                                                       Triple* s) {
  if (threadIdx.x == 0) *s = wait_slot(lb.incl + i);
  __syncthreads();
  return *s;
}

// Zero bytes [lo, hi) of `out`, block `part` of `parts` taking an even
// share of the 16-byte chunks (part 0 also the head, the last part the
// tail before `hi`).
__device__ __forceinline__ void zero_share(uint8_t* __restrict__ out,
                                           long long lo, long long hi,
                                           int part, int parts) {
  if (lo >= hi) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  long long c0 = (long long)(((a + lo + 15) & ~(uintptr_t)15) - a);  // first aligned byte
  long long c1 = (long long)(((a + hi) & ~(uintptr_t)15) - a);       // end of whole chunks
  if (c0 > hi) c0 = hi;
  if (c1 < c0) c1 = c0;
  if (part == 0)
    for (long long k = lo + threadIdx.x; k < c0; k += blockDim.x) out[k] = 0;
  if (part == parts - 1)
    for (long long k = c1 + threadIdx.x; k < hi; k += blockDim.x) out[k] = 0;
  const long long chunks = (c1 - c0) / 16;
  const long long per = (chunks + parts - 1) / parts;
  const long long k0 = per * part;
  const long long k1 = k0 + per < chunks ? k0 + per : chunks;
  uint4* o = reinterpret_cast<uint4*>(out + c0);
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x) __stcs(o + k, z);
}

// Blocks of `kernel` at `threads` threads and `smem` bytes of dynamic
// shared memory that are resident at once on the current card: the size
// of a persistent grid. Host calls only (no sync); callers keep the answer
// in a static.
template <typename K>
inline int resident_blocks(K kernel, int threads, int smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int g = sms * (per_sm > 0 ? per_sm : 1);
  return g < 1 ? 1 : g;
}


// ---- Wide slots: the same scan with 64-bit counts (compose8.cu) -----------
//
// UTF-16 -> UTF-8 writes up to 4 bytes a unit, so the output count of a
// buffer of up to 2^31 units needs 33 bits, past the 32-bit `count` of a
// Slot. A wide slot is three 64-bit words, count | 2^63, before | 2^63 and
// key | 2^63, each written once from zero and each single-copy atomic; a
// reader takes the slot as published only when all three ready bits are
// set, so the argument above holds word for word. The counter and the two
// slot arrays fill the same 16 + 48 nt bytes as a Lookback's scratch (no
// extra words), all of which the reset clears.

struct Wide {
  long long count;
  long long before;  // count before `key`, or `count` when key == NO_EVENT
  unsigned long long key;
};

__device__ __forceinline__ Wide wide(long long count, long long before,
                                     unsigned long long key) {
  Wide r;
  r.count = count;
  r.before = before;
  r.key = key;
  return r;
}

// a is the earlier of two adjacent runs of tiles
__device__ __forceinline__ Wide combine(const Wide& a, const Wide& b) {
  return wide(a.count + b.count, a.key < b.key ? a.before : a.count + b.before,
              a.key < b.key ? a.key : b.key);
}

struct alignas(8) WideSlot {
  unsigned long long w[3];  // count, before, key; each | 2^63 once published
};

constexpr unsigned long long READY = 1ull << 63;

__device__ __forceinline__ void publish(WideSlot* s, const Wide& v) {
  st_relaxed(&s->w[0], (unsigned long long)v.count | READY);
  st_relaxed(&s->w[1], (unsigned long long)v.before | READY);
  st_relaxed(&s->w[2], v.key | READY);
}

// loads wide slot s; true (and its value) when all three words are published
__device__ __forceinline__ bool peek(const WideSlot* s, Wide* v) {
  const unsigned long long c = ld_relaxed(&s->w[0]), b = ld_relaxed(&s->w[1]),
                           k = ld_relaxed(&s->w[2]);
  *v = wide((long long)(c & ~READY), (long long)(b & ~READY), k & ~READY);
  return (c & b & k & READY) != 0;
}

__device__ __forceinline__ Wide shfl_down(const Wide& v, int d) {
  return wide(__shfl_down_sync(FULL, v.count, d), __shfl_down_sync(FULL, v.before, d),
              __shfl_down_sync(FULL, v.key, d));
}

__device__ __forceinline__ Wide shfl0(const Wide& v) {
  return wide(__shfl_sync(FULL, v.count, 0), __shfl_sync(FULL, v.before, 0),
              __shfl_sync(FULL, v.key, 0));
}

//   [0, 16)              the tile counter (and padding)
//   [16, 16 + 24 nt)     the aggregate slots
//   [16 + 24 nt, + 24 nt) the inclusive slots
struct WideLookback {
  unsigned* counter;
  WideSlot* agg;
  WideSlot* incl;
};

inline long long wide_lookback_bytes(int nt) { return 16 + 48ll * nt; }

inline WideLookback wide_lookback_carve(void* scratch, int nt) {
  char* base = static_cast<char*>(scratch);
  WideLookback lb;
  lb.counter = reinterpret_cast<unsigned*>(base);
  lb.agg = reinterpret_cast<WideSlot*>(base + 16);
  lb.incl = reinterpret_cast<WideSlot*>(base + 16 + 24ll * nt);
  return lb;
}

// Clears the counter and both slot arrays on `stream`; returns the cudaError_t.
inline int wide_lookback_reset(void* scratch, int nt, cudaStream_t stream) {
  return (int)cudaMemsetAsync(scratch, 0, (size_t)wide_lookback_bytes(nt), stream);
}

// Thread 0: publish tile t's aggregate (tile 0's is also its inclusive value).
__device__ __forceinline__ void publish_aggregate(const WideLookback& lb, int t,
                                                  const Wide& agg) {
  if (t == 0) publish(lb.incl, agg);
  publish(lb.agg + t, agg);
}

// lookback_prefix on wide slots, over windows of K x 32 tiles: the
// exclusive prefix of tile t > 0, computed by one whole warp (every lane
// gets it). Lane L looks at tiles j - K L - k, k = 0..K-1 (all their slots
// loaded at once), and folds its group from its latest tile back to its
// latest inclusive value. The window is folded once every lane up to the
// nearest inclusive value holds its group; windows step back until one
// holds an inclusive value (tiles before 0 count as an inclusive identity).
template <int K>
__device__ __forceinline__ Wide lookback_prefix(const WideLookback& lb, int t) {
  const int lane = threadIdx.x & 31;
  Wide acc = wide(0, 0, NO_EVENT);
  for (int j = t - 1;; j -= 32 * K) {
    Wide g = wide(0, 0, NO_EVENT);
    bool inc = false, ready = false;
    for (int ns = 32;;) {
      if (!ready) {
        Wide vi[K], va[K];
        bool pi[K], pa[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = j - K * lane - k;
          pi[k] = i >= 0 && peek(lb.incl + i, &vi[k]);
          pa[k] = i >= 0 && peek(lb.agg + i, &va[k]);
        }
        g = wide(0, 0, NO_EVENT);
        inc = false;
        ready = true;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (inc || !ready) continue;
          if (j - K * lane - k < 0) {
            inc = true;
          } else if (pi[k]) {
            g = combine(vi[k], g);
            inc = true;
          } else if (pa[k]) {
            g = combine(va[k], g);
          } else {
            ready = false;
          }
        }
      }
      const unsigned incl = __ballot_sync(FULL, inc && ready);
      const unsigned need = incl ? (2u << (__ffs(incl) - 1)) - 1 : FULL;
      if ((__ballot_sync(FULL, ready) & need) == need) break;
      backoff(&ns);
    }
    const unsigned incl = __ballot_sync(FULL, inc && ready);
    const int stop = __ffs(incl) - 1;  // -1: no inclusive value in the window
    if (incl && lane > stop) g = wide(0, 0, NO_EVENT);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Wide o = shfl_down(g, d);
      if (lane + d < 32) g = combine(o, g);
    }
    acc = combine(shfl0(g), acc);
    if (incl) return acc;
  }
}

// Thread 0 waits for tile i's inclusive value; every thread of the block
// gets it (through `s`).
__device__ __forceinline__ Wide block_wait_inclusive(const WideLookback& lb, int i,
                                                     Wide* s) {
  if (threadIdx.x == 0) {
    Wide v;
    for (int ns = 32; !peek(lb.incl + i, &v);) backoff(&ns);
    *s = v;
  }
  __syncthreads();
  return *s;
}

}  // namespace su
