// census_utf8: one read of a UTF-8 buffer into the routing bits of
// simdutf_tpu/kernels/census.census_bits (Pallas kernel _census_kernel).
//
// Floor: HBM bytes, one streaming read of `length` bytes. The checks run
// four bytes at a time on 32-bit words (SWAR: each byte's flag in its bit
// 7), with the next byte of each word funnel-shifted in from its neighbour
// and, at a chunk's end, shuffled from the next lane. The result is an OR,
// so a warp skips every check whose bit it already holds: its running OR
// (one __reduce_or_sync a chunk, warp-uniform, so no lane diverges) soon
// holds V2, V3 and V4 on text that no fixed-rate class admits, and from
// then on the warp runs only the presence tests it still needs (a
// vote on the chunk's high bits, then one or two SWAR operations a word).
// A warp that holds every bit stops. Text of one fixed-rate class keeps
// its class's positional check on every chunk.
//
// A warp reads 32 x U consecutive 16-byte chunks a step, grid-stride. The
// chunks are 16-byte aligned in memory: a base pointer b that is not
// aligned puts its bytes at q = p + (b & 15) of the aligned frame, which
// only moves the lane masks of the position classes (p % 2, 3, 4) and the
// in-range masks of the first and last chunk. Every aligned chunk read
// holds a stored byte (bytes past the buffer end are zeroed in registers,
// as the JAX census reads them). out[1] counts the in-range chunks that
// ran a positional check (V2, V3 or V4 not yet held by the warp).
#include "utf8.cuh"

namespace {

constexpr unsigned NONASCII = 1, V2 = 2, V3 = 4, V4 = 8, HAS2 = 16, HAS4 = 32,
                   HASLO = 64;
constexpr unsigned ALL = 127, POSITIONAL = V2 | V3 | V4;
constexpr unsigned HI = 0x80808080u;  // bit 7 of each byte: the byte's flag
constexpr int THREADS = 256;
constexpr int U = 4;  // 16-byte chunks a lane reads a step
constexpr int BLOCKS_PER_SM = 4;

// the bytes [0, c) of a word, c clamped to [0, 4]
__device__ __forceinline__ unsigned low_bytes(long long c) {
  return c <= 0 ? 0u : c >= 4 ? ~0u : (1u << (8 * (int)c)) - 1u;
}

// aligned chunk k, zero past `stored` (the buffer end in the aligned frame)
__device__ __forceinline__ uint4 load_chunk(const uint4* __restrict__ g,
                                            long long k, long long stored) {
  uint4 v = make_uint4(0, 0, 0, 0);
  const long long e = stored - 16 * k;
  if (e > 0) {
    v = __ldg(g + k);
    if (e < 16) {
      v.x &= low_bytes(e);
      v.y &= low_bytes(e - 4);
      v.z &= low_bytes(e - 8);
      v.w &= low_bytes(e - 12);
    }
  }
  return v;
}

// Each flag word carries one check's result in bit 7 of each byte; OR-ed
// over a step's words, then folded into the result bits.
struct Flags {
  unsigned hi = 0, lo = 0, v2 = 0, v3 = 0, v4 = 0, has2 = 0, has4 = 0;

  __device__ __forceinline__ unsigned bits() const {
    return ((hi & HI) ? NONASCII : 0u) | ((v2 & HI) ? V2 : 0u) |
           ((v3 & HI) ? V3 : 0u) | ((v4 & HI) ? V4 : 0u) |
           ((has2 & HI) ? HAS2 : 0u) | ((has4 & HI) ? HAS4 : 0u) |
           ((lo & HI) ? HASLO : 0u);
  }
};

// The presence tests of word x under in-range mask m, for the bits in
// `need`: a byte >= 0x80, a byte < 0x80, a 2-byte lead (110xxxxx), a byte
// >= 0xF0.
__device__ __forceinline__ void presence(unsigned x, unsigned m, unsigned need,
                                         Flags& f) {
  if (need & NONASCII) f.hi |= x & m;
  if (need & HASLO) f.lo |= ~x & m;
  if (need & HAS2) f.has2 |= x & (x << 1) & ~(x << 2) & m;
  if (need & HAS4) f.has4 |= ((x & 0x7F7F7F7Fu) + 0x10101010u) & x & m;
}

// The presence tests and the positional checks of word x (next bytes x1,
// in-range mask m) for the bits in `need`. m2, m3, m4: the bytes at a
// position p with p % 2, p % 3, p % 4 == 0 (where a lead must stand).
__device__ __forceinline__ void positional(unsigned x, unsigned x1, unsigned m,
                                           unsigned m2, unsigned m3,
                                           unsigned m4, unsigned need,
                                           Flags& f) {
  const unsigned s1 = x << 1, s2 = x << 2, s3 = x << 3;
  const unsigned cont = x & ~s1;        // 10xxxxxx
  const unsigned lead2 = x & s1 & ~s2;  // 110xxxxx
  const unsigned ge_f0 = ((x & 0x7F7F7F7Fu) + 0x10101010u) & x;
  presence(x, m, need, f);
  if (need & V2) {
    // C2..DF at even positions: a 2-byte lead that is not C0 or C1
    const unsigned lead = lead2 & ((x & 0x1E1E1E1Eu) + 0x7F7F7F7Fu);
    f.v2 |= ~((m2 & lead) | (~m2 & cont)) & m;
  }
  if (need & (V3 | V4)) {
    const unsigned next_cont = x1 & ~(x1 << 1);
    if (need & V3) {
      // E0..EF with a continuation after it; E0 needs A0..BF, ED 80..9F:
      // the low nibble may not be D where bit 5 of the next byte is set,
      // nor 0 where it is clear
      const unsigned lead3 = x & s1 & s2 & ~s3;
      const unsigned barred = ((x1 >> 5) & 0x01010101u) * 0x0Du;
      const unsigned allowed = ((x ^ barred) & 0x0F0F0F0Fu) + 0x7F7F7F7Fu;
      const unsigned lead = lead3 & next_cont & allowed;
      f.v3 |= ~((m3 & lead) | (~m3 & cont)) & m;
    }
    if (need & V4) {
      // F0..F4 with a continuation after it; F0 needs 90..BF, F4 80..8F:
      // the low nibble plus "bits 5:4 of the next byte are not 00" must
      // lie in [1, 4]
      const unsigned up = ((x1 >> 4) | (x1 >> 5)) & 0x01010101u;
      const unsigned v = (x & 0x0F0F0F0Fu) + up;
      const unsigned lead =
          ge_f0 & next_cont & (v + 0x7F7F7F7Fu) & ~(v + 0x7B7B7B7Bu);
      f.v4 |= ~((m4 & lead) | (~m4 & cont)) & m;
    }
  }
}

// the bytes j of a word whose first byte has p % 3 == r with (r + j) % 3 == 0
__device__ __forceinline__ unsigned lead3_lanes(int r) {
  return r == 0 ? 0x80000080u : r == 1 ? 0x00800000u : 0x00008000u;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    census_utf8_kernel(const uint8_t* __restrict__ b, long long n,
                       long long length, int* __restrict__ out) {
  const int a = (int)(reinterpret_cast<uintptr_t>(b) & 15);
  const uint4* __restrict__ g = reinterpret_cast<const uint4*>(b - a);
  const long long in_end = a + length;  // in range: a <= q < in_end
  const long long stored = a + n;       // stored: q < stored
  const long long chunks = (in_end + 15) >> 4;
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)THREADS + threadIdx.x) >> 5;
  const long long step = ((gridDim.x * (long long)THREADS) >> 5) * (32 * U);
  // p = q - a: leads of the uniform classes stand at p % 2, p % 4 == 0
  const unsigned m2 = (a & 1) ? 0x80008000u : 0x00800080u;
  const unsigned m4 = 0x80u << (8 * (a & 3));
  // p % 3 of lane's chunk k = t + 32u + lane is (t + 2u + lane - a) % 3
  const int lane3 = lane % 3 + 3 - a % 3;
  const int step3 = (int)(step % 3);
  long long t = warp * (32 * U);
  int t3 = (int)(t % 3);
  unsigned known = 0, bits = 0, checked = 0;
  for (; t < chunks; t += step, t3 = (t3 + step3) % 3) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load_chunk(g, t + 32 * u + lane, stored);
    // the first word after the step's last chunk, for lane 31's last byte
    unsigned after = 0;
    if ((~known & (V3 | V4)) && lane == 31)
      after = load_chunk(g, t + 32 * U, stored).x;
    Flags f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k = t + 32 * u + lane;
      const unsigned need = ALL & ~known;
      const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      unsigned m[4] = {~0u, ~0u, ~0u, ~0u};
      const long long lo = a - 16 * k, hi = in_end - 16 * k;
      if (lo > 0 || hi < 16) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m[i] = low_bytes(hi - 4 * i) & ~low_bytes(lo - 4 * i);
      }
      if (need & POSITIONAL) {
        // the next chunk's first word: the next lane's, for lane 31 the
        // next u's lane 0, after the last u the word loaded above
        const unsigned down = __shfl_down_sync(su::FULL, w[0], 1);
        const unsigned wrap = __shfl_sync(su::FULL, v[(u + 1) % U].x, 0);
        const unsigned next = lane != 31 ? down : u + 1 < U ? wrap : after;
        const int r = (t3 + 2 * u + lane3) % 3;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned x1 = __funnelshift_r(w[i], i < 3 ? w[i + 1] : next, 8);
          positional(w[i], x1, m[i], m2, lead3_lanes((r + i) % 3), m4, need,
                     f);
        }
        checked += k < chunks;
        bits |= f.bits();
        known |= __reduce_or_sync(su::FULL, bits);
      } else {
        if (need & HASLO) {
#pragma unroll
          for (int i = 0; i < 4; ++i) f.lo |= ~w[i] & m[i];
        }
        // NONASCII, HAS2 and HAS4 need a byte >= 0x80 somewhere in the
        // chunk: one vote spares an ASCII chunk their tests
        if ((need & (NONASCII | HAS2 | HAS4)) &&
            __any_sync(su::FULL, (w[0] | w[1] | w[2] | w[3]) & HI)) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            presence(w[i], m[i], need & (NONASCII | HAS2 | HAS4), f);
        }
      }
    }
    bits |= f.bits();
    known |= __reduce_or_sync(su::FULL, bits);
    if (known == ALL) break;
  }
  checked = __reduce_add_sync(su::FULL, checked);
  if (lane == 0) {
    if (known) atomicOr(out, (int)known);
    if (checked) atomicAdd(out + 1, (int)checked);
  }
}

}  // namespace

// out: two zeroed int32 on the device: the bits, then the in-range 16-byte
// chunks (of the buffer's 16-byte-aligned frame) that ran a positional
// check. Returns cudaGetLastError().
extern "C" int census_utf8(const uint8_t* b, long long n, long long length,
                           int* out, void* stream) {
  const long long chunks =
      ((long long)(reinterpret_cast<uintptr_t>(b) & 15) + length + 15) / 16;
  long long blocks = (chunks + THREADS * U - 1) / (THREADS * U);
  if (blocks > 132 * BLOCKS_PER_SM) blocks = 132 * BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  census_utf8_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      b, n, length, out);
  return (int)cudaGetLastError();
}
