// utf8_first_event: exact first UTF-8 error of a buffer (replaces the Pallas
// kernels _utf8_kernel_len / _utf8_kernel behind
// simdutf_tpu/kernels/validate.utf8_first_event_len / utf8_first_event).
// utf8_count: length-masked counts (replaces _count_kernel behind
// validate.utf8_count / utf8_utf16_length / latin1_utf8_length).
//
// ascii_first_bad: the first byte >= 0x80 below a length (replaces the
// Pallas kernel _ascii_kernel behind validate.ascii_first_bad, which takes
// no length and relies on the zero tail of its padded layout).
//
// Floor: HBM bytes, one streaming read of `length` bytes each. The TPU
// kernels carry the running minimum in an output block across a
// sequential grid; Hopper blocks run in no order, so each warp reduces and
// makes one atomic update (atomicMin on the 64-bit key pos << 8 | code,
// atomicAdd on the count). Bytes at/after `length` read as zero, so a
// sequence cut at the length reports TOO_SHORT at its lead.
//
// The first-event kernel reads as census.cu does: a warp takes 32 x U
// consecutive 16-byte chunks a step (one 16-byte load a lane a chunk),
// grid-stride, and gets the word before and after each chunk from its
// neighbour lanes by shuffle. It screens every chunk that holds a byte
// >= 0x80 with branch-free SWAR flags on 32-bit words (each byte's flag
// in its bit 7), which mark exactly the bytes su::event_key reports an
// event on, each on the event's own byte. Valid text flags nothing, so the
// hot loop is loads, shuffles and ~40 integer operations a word, with no
// branch a byte. Those operations bound it: on an H100 (700 W), 63 us on
// 64 MiB of text with a byte >= 0x80 in almost every chunk, against 20 us
// for the bytes and ~24 us for the same reads with no screen; the
// structural flags take ~23 us of it, the lead and second-byte flags ~16.
// The first chunks a warp vote finds flagged end the warp's walk
// (everything after them lies further on); the lattice then runs once,
// after the loop, on each flagged byte in order, from a window read back
// from memory. A warp also stops once a result below its next step is
// already in *out, so error-dense input reads little.
//
// Given a counter `exact`, the kernel also adds to it the chunks that ran
// the event lattice (the flagged chunks where each warp stopped; on valid
// text none), one atomicAdd a warp.
#include "utf8.cuh"

namespace {

constexpr unsigned HI = 0x80808080u;  // bit 7 of each byte: the byte's flag
constexpr int FE_THREADS = 256;
constexpr int FE_U = 4;  // 16-byte chunks a lane reads a step
constexpr int FE_BLOCKS_PER_SM = 4;

// the bytes [0, c) of a word, c clamped to [0, 4]
__device__ __forceinline__ unsigned low_bytes(long long c) {
  return c <= 0 ? 0u : c >= 4 ? ~0u : (1u << (8 * (int)c)) - 1u;
}

// the 4-byte word at byte q (a multiple of 4), zero outside [0, length);
// vec: the base is 16-byte aligned
__device__ __forceinline__ unsigned load_word(const uint8_t* __restrict__ b,
                                              long long q, long long length,
                                              bool vec) {
  const long long e = length - q;
  if (q < 0 || e <= 0) return 0u;
  unsigned w = 0;
  if (vec) {
    w = __ldg(reinterpret_cast<const unsigned*>(b + q));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < e) w |= (unsigned)__ldg(b + q + j) << (8 * j);
  }
  return w & low_bytes(e);
}

// chunk k (bytes 16k .. 16k + 15), zero at/after length
__device__ __forceinline__ uint4 load_chunk16(const uint8_t* __restrict__ b,
                                             long long k, long long length,
                                             bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  const long long e = length - 16 * k;
  if (e <= 0) return v;
  if (vec) {
    v = __ldg(reinterpret_cast<const uint4*>(b) + k);
    if (e < 16) {
      v.x &= low_bytes(e);
      v.y &= low_bytes(e - 4);
      v.z &= low_bytes(e - 8);
      v.w &= low_bytes(e - 12);
    }
  } else {
    v.x = load_word(b, 16 * k, length, false);
    v.y = load_word(b, 16 * k + 4, length, false);
    v.z = load_word(b, 16 * k + 8, length, false);
    v.w = load_word(b, 16 * k + 12, length, false);
  }
  return v;
}

// Leads of x (bit 7 of each byte): of 2-, 3- and 4-byte sequences, C0..F7,
// E0..F7 and F0..F7 (seqlen_of > 1, > 2, > 3); F8..FF start nothing.
struct Leads {
  unsigned l2, l3, l4;
};

__device__ __forceinline__ Leads leads_of(unsigned x) {
  const unsigned c0 = x & (x << 1), e0 = c0 & (x << 2), f0 = e0 & (x << 3);
  const unsigned f8 = f0 & (x << 4);
  return {c0 & ~f8, e0 & ~f8, f0 & ~f8};
}

// continuation bytes 10xxxxxx
__device__ __forceinline__ unsigned cont_of(unsigned x) { return x & ~(x << 1); }

// The screen of word x, bit 7 of each byte set exactly where su::event_key
// reports an event. xn: the next word; lp, lx: the leads of the previous
// word and of x; cx, cn: the continuations of x and of xn.
__device__ __forceinline__ unsigned screen(unsigned x, unsigned xn, Leads lp,
                                           Leads lx, unsigned cx,
                                           unsigned cn) {
  // a continuation that no lead among the three bytes before it covers
  const unsigned covered = __funnelshift_l(lp.l2, lx.l2, 8) |
                           __funnelshift_l(lp.l3, lx.l3, 16) |
                           __funnelshift_l(lp.l4, lx.l4, 24);
  const unsigned orphan = cx & ~covered;
  // a lead whose next 1, 2 or 3 bytes are not all continuations
  const unsigned cut = (lx.l2 & ~__funnelshift_r(cx, cn, 8)) |
                       (lx.l3 & ~__funnelshift_r(cx, cn, 16)) |
                       (lx.l4 & ~__funnelshift_r(cx, cn, 24));
  const unsigned s1 = x << 1, s2 = x << 2, s3 = x << 3;
  // C0, C1: a 2-byte lead whose bits 4:1 are all clear
  const unsigned c0c1 = x & s1 & ~s2 & ~((x & 0x1E1E1E1Eu) + 0x7F7F7F7Fu);
  // E0 before a byte < A0, ED before a byte >= A0: the low nibble may not
  // be D where bit 5 of the next byte is set, nor 0 where it is clear
  // (census.cu's `barred` / `allowed`)
  const unsigned x1 = __funnelshift_r(x, xn, 8);
  const unsigned barred = ((x1 >> 5) & 0x01010101u) * 0x0Du;
  const unsigned bad3 =
      x & s1 & s2 & ~s3 & ~(((x ^ barred) & 0x0F0F0F0Fu) + 0x7F7F7F7Fu);
  // F0 before a byte < 90, F4 before a byte >= 90, F5..FF: the low nibble
  // plus "bits 5:4 of the next byte are not 00" must lie in [1, 4]
  // (census.cu's `up` / `v`)
  const unsigned up = ((x1 >> 4) | (x1 >> 5)) & 0x01010101u;
  const unsigned v = (x & 0x0F0F0F0Fu) + up;
  const unsigned bad4 =
      x & s1 & s2 & s3 & ~((v + 0x7F7F7F7Fu) & ~(v + 0x7B7B7B7Bu));
  return (orphan | cut | c0c1 | bad3 | bad4) & HI;
}

// The key of the first flagged byte that su::event_key reports, in the
// chunk at p0 with flag words f; its window is read back from memory.
__device__ __forceinline__ unsigned long long flagged_key(
    const uint8_t* __restrict__ b, long long length, long long p0,
    const unsigned f[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (unsigned m = f[i]; m; m &= m - 1) {
      const long long p = p0 + 4 * i + ((__ffs(m) - 1) >> 3);
      int c[7];  // bytes p - 3 .. p + 3
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const long long q = p - 3 + j;
        c[j] = q >= 0 && q < length ? b[q] : 0;
      }
      const unsigned long long e =
          su::event_key(p, c[3], c[4], c[5], c[6], c[2], c[1], c[0]);
      if (e != su::NO_EVENT) return e;
    }
  }
  return su::NO_EVENT;
}

__global__ void __launch_bounds__(FE_THREADS, FE_BLOCKS_PER_SM)
    first_event_kernel(const uint8_t* __restrict__ b, long long length,
                       unsigned long long* __restrict__ out,
                       unsigned long long* __restrict__ exact) {
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long chunks = (length + 15) >> 4;
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)FE_THREADS + threadIdx.x) >> 5;
  const long long step = ((gridDim.x * (long long)FE_THREADS) >> 5) * (32 * FE_U);
  unsigned f[4] = {0, 0, 0, 0};  // the flags of this lane's chunk where the warp stopped
  long long p0 = 0;               // that chunk's first byte
  bool stop = false;
  for (long long t = warp * (32 * FE_U); t < chunks && !stop; t += step) {
    uint4 v[FE_U];
#pragma unroll
    for (int u = 0; u < FE_U; ++u)
      v[u] = load_chunk16(b, t + 32 * u + lane, length, vec);
    // the words either side of the step: lane 0's first chunk looks back
    // into the word before, lane 31's last chunk ahead into the word after
    const unsigned before = lane == 0 ? load_word(b, 16 * t - 4, length, vec) : 0u;
    const unsigned after =
        lane == 31 ? load_word(b, 16 * (t + 32 * FE_U), length, vec) : 0u;
    // one read, broadcast, so the whole warp leaves together
    unsigned long long found =
        lane == 0 ? *reinterpret_cast<volatile unsigned long long*>(out) : 0;
    found = __shfl_sync(su::FULL, found, 0);
    if (found != su::NO_EVENT && (found >> 8) < (unsigned long long)(16 * t)) break;
#pragma unroll
    for (int u = 0; u < FE_U; ++u) {
      const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      // events sit only on bytes >= 0x80: one vote spares an ASCII chunk
      if (!__any_sync(su::FULL, (w[0] | w[1] | w[2] | w[3]) & HI)) continue;
      // the word before this lane's chunk and the word after it
      const unsigned up = __shfl_up_sync(su::FULL, w[3], 1);
      const unsigned wrap_up = u ? __shfl_sync(su::FULL, v[u ? u - 1 : 0].w, 31) : before;
      const unsigned prev = lane ? up : wrap_up;
      const unsigned down = __shfl_down_sync(su::FULL, w[0], 1);
      const unsigned wrap_down =
          u + 1 < FE_U ? __shfl_sync(su::FULL, v[u + 1 < FE_U ? u + 1 : u].x, 0) : after;
      const unsigned next = lane != 31 ? down : wrap_down;
      const unsigned c[5] = {cont_of(w[0]), cont_of(w[1]), cont_of(w[2]),
                             cont_of(w[3]), cont_of(next)};
      Leads lp = leads_of(prev);
      unsigned g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Leads lx = leads_of(w[i]);
        g[i] = screen(w[i], i < 3 ? w[i + 1] : next, lp, lx, c[i], c[i + 1]);
        lp = lx;
      }
      if (__any_sync(su::FULL, g[0] | g[1] | g[2] | g[3])) {
        // the warp's first flagged chunks: nothing after them comes first
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = g[i];
        p0 = 16 * (t + 32 * u + lane);
        stop = true;
        break;
      }
    }
  }
  const bool flagged = (f[0] | f[1] | f[2] | f[3]) != 0;
  unsigned long long key = flagged ? flagged_key(b, length, p0, f) : su::NO_EVENT;
  key = su::warp_min_u64(key);
  if (lane == 0 && key != su::NO_EVENT) atomicMin(out, key);
  if (exact) {
    const unsigned ran = __reduce_add_sync(su::FULL, flagged ? 1u : 0u);
    if (lane == 0 && ran) atomicAdd(exact, (unsigned long long)ran);
  }
}

// Each warp walks 32 consecutive 16-byte chunks per step, all lanes in
// step: a ballot finds the warp's first chunk with a byte >= 0x80, whose
// lowest such byte is then the warp's answer (later steps lie further on),
// so the warp makes one atomicMin and stops. A warp also stops once a
// result below its next step is already in *out.
__global__ void __launch_bounds__(256)
    ascii_kernel(const uint8_t* __restrict__ b, long long length,
                 unsigned long long* __restrict__ out) {
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long chunks = (length + 15) / 16;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = blockIdx.x * (long long)blockDim.x + threadIdx.x - lane;
       base < chunks; base += stride) {
    // one read, broadcast, so the whole warp leaves together
    unsigned long long found =
        lane == 0 ? *reinterpret_cast<volatile unsigned long long*>(out) : 0;
    found = __shfl_sync(su::FULL, found, 0);
    if ((unsigned long long)(base * 16) > found) break;
    const long long k = base + lane;
    const long long p0 = k * 16;
    int first = 16;  // lowest byte >= 0x80 in this lane's chunk; 16: none
    if (k < chunks) {
      if (vec && p0 + 16 <= length) {
        const uint4 m = *reinterpret_cast<const uint4*>(b + p0);
        const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int i = 3; i >= 0; --i) {
          const uint32_t high = w[i] & 0x80808080u;
          if (high) first = 4 * i + ((__ffs(high) - 1) >> 3);
        }
      } else {
        for (int j = 15; j >= 0; --j)
          if (p0 + j < length && b[p0 + j] >= 0x80) first = j;
      }
    }
    const unsigned hits = __ballot_sync(su::FULL, first < 16);
    if (hits) {
      const int src = __ffs(hits) - 1;
      const int f = __shfl_sync(su::FULL, first, src);
      if (lane == 0) atomicMin(out, (unsigned long long)((base + src) * 16 + f));
      break;
    }
  }
}

// per-byte count of the three modes
__device__ __forceinline__ int count_byte(int x, int mode) {
  if (mode == 2) return 1 + (x >= 0x80);        // UTF-8 bytes from Latin-1
  int r = !su::is_cont(x);                      // code points
  if (mode == 1) r += x >= 0xF0;                // + second UTF-16 unit
  return r;
}

__global__ void __launch_bounds__(256)
    count_kernel(const uint8_t* __restrict__ b, long long length, int mode,
                 unsigned long long* __restrict__ out) {
  const bool vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long chunks = (length + 15) / 16;
  unsigned long long total = 0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < chunks; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * 16;
    if (vec && p0 + 16 <= length) {
      // four bytes per 32-bit word: bit 7 of each byte carries the test
      const uint4 m = *reinterpret_cast<const uint4*>(b + p0);
      const uint32_t w[4] = {m.x, m.y, m.z, m.w};
      int s = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = w[i];
        const uint32_t high = x & 0x80808080u;
        if (mode == 2) {
          s += 4 + __popc(high);
        } else {
          s += 4 - __popc(high & ~(x << 1));  // minus continuation bytes
          if (mode == 1) s += __popc(high & (x << 1) & (x << 2) & (x << 3));
        }
      }
      total += s;
    } else {
      for (int j = 0; j < 16 && p0 + j < length; ++j)
        total += count_byte(b[p0 + j], mode);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(su::FULL, total, d);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(out, total);
}

}  // namespace

// out_key: one int64 on the device set to BIG << 8. exact_chunks: null, or
// one int64 on the device that the chunks which ran the lattice are added
// to. Returns cudaGetLastError().
extern "C" int utf8_first_event(const uint8_t* b, long long length,
                                unsigned long long* out_key,
                                unsigned long long* exact_chunks, void* stream) {
  long long blocks = ((length + 15) / 16 + FE_THREADS * FE_U - 1) / (FE_THREADS * FE_U);
  if (blocks > 132 * FE_BLOCKS_PER_SM) blocks = 132 * FE_BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  first_event_kernel<<<(int)blocks, FE_THREADS, 0, (cudaStream_t)stream>>>(
      b, length, out_key, exact_chunks);
  return (int)cudaGetLastError();
}

// out: one int64 on the device set to BIG. Returns cudaGetLastError().
extern "C" int ascii_first_bad(const uint8_t* b, long long length,
                               unsigned long long* out, void* stream) {
  ascii_kernel<<<su::grid_for((length + 15) / 16), 256, 0,
                 (cudaStream_t)stream>>>(b, length, out);
  return (int)cudaGetLastError();
}

// mode 0: code points, 1: UTF-16 units, 2: UTF-8 bytes of Latin-1 input.
// out: one zeroed int64 on the device. Returns cudaGetLastError().
extern "C" int utf8_count(const uint8_t* b, long long length, int mode,
                          unsigned long long* out, void* stream) {
  count_kernel<<<su::grid_for((length + 15) / 16), 256, 0,
                 (cudaStream_t)stream>>>(b, length, mode, out);
  return (int)cudaGetLastError();
}
