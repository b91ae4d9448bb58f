// The per-tile pieces of the single-pass UTF-8 look-back kernels, shared by
// compose16.cu (UTF-8 -> UTF-16) and compose32.cu (UTF-8 -> UTF-32): the
// window a thread reads, the marks of the bytes that carry output, the fast
// check of the error lattice, the exact triple of a flagged tile and the
// branch-free decode of a lead.
//
// A thread owns PER consecutive bytes of a tile (WORDS = PER / 4 words)
// and reads them with 8 bytes of halo before and 4 after, as NWIN = WORDS + 3
// little-endian words: words 0-1 the halo before, 2..WORDS+1 its own, the
// last the 4 bytes after.
//
// The fast check may flag valid text but never misses an event of
// utf8.cuh's event_key lattice: a structural test (every byte a lead asks
// for is a continuation and no other byte is) and the value tests of
// simdutf's lookup tables (C0/C1, E0 and ED, F0 and F4-F7 against the next
// byte, F8-FF), as bit masks on the words. Every event at a byte of a tile
// shows as a flag at that byte, at up to three bytes after it, or (an
// orphan continuation after an F8-FF byte) as the F8-FF byte up to three
// bytes before it; so a tile checks the four bytes after it, and the four
// before it for F8-FF. Only a tile the check flags computes exact keys.
// kernels/compose16.tile_flags_ref is the plain twin of the check.
#pragma once

#include "lookback.cuh"

namespace su {

constexpr uint32_t H = 0x80808080u;

// bit 7 of each byte set where that byte lies below `lim`, of the word of
// bytes q0 .. q0 + 3
__device__ __forceinline__ uint32_t below(long long q0, long long lim) {
  const long long k = lim - q0;
  return k >= 4 ? H : k <= 0 ? 0u : H & ((1u << (8 * k)) - 1u);
}

// byte classes of a word, as bit 7 of each byte
struct Classes {
  uint32_t cont, lead, l3, l4, l5;
};

__device__ __forceinline__ Classes classes(uint32_t w) {
  Classes c;
  const uint32_t hi = w & H;
  c.cont = hi & ~(w << 1);          // 10xxxxxx
  c.lead = hi & (w << 1);           // 11xxxxxx
  c.l3 = c.lead & (w << 2);         // >= E0
  c.l4 = c.l3 & (w << 3);           // >= F0
  c.l5 = c.l4 & (w << 4);           // >= F8: never valid
  return c;
}

// leads whose next byte decides an error: E0 (next < A0 is overlong), ED
// (next >= A0 a surrogate), F0 (next < 90 overlong), F4 (next >= 90 too
// large)
struct Special {
  uint32_t e0, ed, f0, f4;
};

__device__ __forceinline__ Special special(uint32_t w, const Classes& c) {
  const uint32_t lo = w & 0x0F0F0F0Fu;
  const uint32_t zero = ~(lo + 0x7F7F7F7Fu) & H;                 // low nibble 0
  const uint32_t is_d = ~((lo ^ 0x0D0D0D0Du) + 0x7F7F7F7Fu) & H;  // low nibble D
  const uint32_t is_4 = ~((lo ^ 0x04040404u) + 0x7F7F7F7Fu) & H;  // low nibble 4
  const uint32_t l3x = c.l3 & ~c.l4, l4x = c.l4 & ~c.l5;
  Special s;
  s.e0 = l3x & zero;
  s.ed = l3x & is_d;
  s.f0 = l4x & zero;
  s.f4 = l4x & is_4;
  return s;
}

__device__ __forceinline__ uint32_t fwd(uint32_t prev, uint32_t cur, int bytes) {
  return __funnelshift_l(prev, cur, 8 * bytes);
}

// Bytes of word w (classes c, s; the previous word's cp, sp) where the fast
// check flags.
__device__ __forceinline__ uint32_t check_word(uint32_t w, const Classes& c,
                                               const Special& s,
                                               const Classes& cp,
                                               const Special& sp) {
  const uint32_t need = fwd(cp.lead, c.lead, 1) | fwd(cp.l3, c.l3, 2) |
                        fwd(cp.l4, c.l4, 3);
  uint32_t err = (need ^ c.cont) | c.l5;
  // C0 and C1: a 2-byte lead with bits 4..1 clear is always an error
  err |= c.lead & ~c.l3 & ~((w & 0x1E1E1E1Eu) + 0x7F7F7F7Fu) & H;
  // F5-F7: too large whatever follows
  err |= c.l4 & ~c.l5 & ((w & 0x07070707u) + 0x7B7B7B7Bu) & H;
  const uint32_t b5 = (w << 2) & H;                             // bit 5 set
  const uint32_t b54 = ((w & 0x30303030u) + 0x7F7F7F7Fu) & H;   // bit 5 or 4
  err |= (fwd(sp.e0, s.e0, 1) & ~b5) | (fwd(sp.ed, s.ed, 1) & b5) |
         (fwd(sp.f0, s.f0, 1) & ~b54) | (fwd(sp.f4, s.f4, 1) & b54);
  return err;
}

// The window of the thread whose bytes start at s (see above), zero
// outside [0, length); `vec` says b is 16-byte aligned. Returns whether the
// whole window lies in range (then no byte needs a mask).
template <int WORDS>
__device__ __forceinline__ bool load_window(const uint8_t* __restrict__ b,
                                            long long s, long long length,
                                            bool vec, uint32_t (&w)[WORDS + 3]) {
  constexpr int PER = 4 * WORDS;
  const bool full = vec && s >= 8 && s + PER + 4 <= length;
  if (full) {
    const uint2 h = *reinterpret_cast<const uint2*>(b + s - 8);
    w[0] = h.x;
    w[1] = h.y;
#pragma unroll
    for (int k = 0; k < WORDS / 4; ++k) {
      const uint4 m = *reinterpret_cast<const uint4*>(b + s + 16 * k);
      w[2 + 4 * k] = m.x;
      w[3 + 4 * k] = m.y;
      w[4 + 4 * k] = m.z;
      w[5 + 4 * k] = m.w;
    }
    w[WORDS + 2] = *reinterpret_cast<const uint32_t*>(b + s + PER);
  } else {
#pragma unroll
    for (int k = 0; k < WORDS + 3; ++k) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long q = s - 8 + 4 * k + j;
        if (q >= 0 && q < length) v |= (uint32_t)b[q] << (8 * j);
      }
      w[k] = v;
    }
  }
  return full;
}

// Marks and checks the thread's own words of window w (bytes from s). km[k]
// gets bit 7 of each byte of word k that carries output: an in-range
// non-continuation byte and, with AFTER4 (UTF-16: the low surrogate), the
// byte after a 4-byte lead below n, which then also has bit 6. *cnt gets
// the marked bytes. Returns the fast check's flags of the thread's bytes,
// of the four bytes before the tile (F8-FF) for the first thread and of
// the four after it for the last (thread TT - 1: a tile is TT threads,
// threads 0 .. TT - 1 of the block).
template <int WORDS, bool AFTER4, int TT>
__device__ __forceinline__ uint32_t mark_and_check(const uint32_t (&w)[WORDS + 3],
                                                   long long s, long long length,
                                                   long long n, bool full,
                                                   uint32_t (&km)[WORDS], int* cnt) {
  uint32_t flag = 0;
  int c_all = 0;
  Classes cp = classes(w[1]);
  Special sp = special(w[1], cp);
  if (threadIdx.x == 0) flag |= cp.l5;  // an F8-FF byte up to 4 before the tile
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const uint32_t x = w[2 + k];
    const Classes c = classes(x);
    const Special sx = special(x, c);
    flag |= check_word(x, c, sx, cp, sp);
    uint32_t keep = ~c.cont & H;
    if constexpr (AFTER4) {
      const uint32_t after4 = fwd(cp.l4 & ~cp.l5, c.l4 & ~c.l5, 1);
      if (!full) {
        const long long q = s + 4 * k;
        keep = ((keep & below(q, length)) | after4) & below(q, n);
      } else {
        keep |= after4;
      }
      km[k] = keep | ((after4 & keep) >> 1);
    } else {
      if (!full) keep &= below(s + 4 * k, length);
      km[k] = keep;
    }
    c_all += __popc(keep);
    cp = c;
    sp = sx;
  }
  if (threadIdx.x == TT - 1) {  // events of the tile's last leads
    const Classes c = classes(w[WORDS + 2]);
    flag |= check_word(w[WORDS + 2], c, special(w[WORDS + 2], c), cp, sp);
  }
  *cnt = c_all;
  return flag;
}

// The least event key of utf8.cuh's event_key lattice among the thread's
// bytes (from s, tile offset threadIdx.x * PER) of a tile the fast check
// flagged: s_b[r] is the byte at tile offset r (r >= -3; zero past
// `length`). A rolled loop over the staged bytes: this path is rare, and its
// registers would otherwise count against every tile's occupancy.
template <int WORDS>
__device__ __forceinline__ unsigned long long exact_key(const uint8_t* s_b, long long s,
                                                        long long length) {
  constexpr int PER = 4 * WORDS;
  unsigned long long key = NO_EVENT;
#pragma unroll 1
  for (int j = 0; j < PER && s + j < length; ++j) {
    const int r = threadIdx.x * PER + j;
    const unsigned long long e =
        event_key(s + j, s_b[r], s_b[r + 1], s_b[r + 2], s_b[r + 3],
                  s_b[r - 1], s_b[r - 2], s_b[r - 3]);
    key = e < key ? e : key;
  }
  return key;
}

// The thread's marked bytes (marks km, bytes from s) before position epos.
template <int WORDS>
__device__ __forceinline__ int marked_before(const uint32_t (&km)[WORDS], long long s,
                                             long long epos) {
  int pre = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) pre += __popc(km[k] & H & below(s + 4 * k, epos));
  return pre;
}

// The exact (count, least key, count before it) of a tile the fast check
// flagged, over a block of NW warps: exact_key and marked_before of each
// thread (marks km), reduced; tile_cnt is the tile's marked bytes.
template <int NW, int WORDS>
__device__ __forceinline__ Triple exact_triple(const uint8_t* s_b, long long s,
                                               long long length,
                                               const uint32_t (&km)[WORDS],
                                               int tile_cnt,
                                               unsigned long long* s_key,
                                               int* s_scan) {
  const unsigned long long key = block_min_u64<NW>(exact_key<WORDS>(s_b, s, length), s_key);
  int pre = key != NO_EVENT ? marked_before(km, s, (long long)(key >> 8)) : 0;
  pre = block_sum<NW>(pre, s_scan);
  return triple(tile_cnt, key == NO_EVENT ? tile_cnt : pre, key);
}

// The 4 bytes from tile offset r of the staged little-endian words s_w
// (the byte at r lowest).
__device__ __forceinline__ uint32_t window_at(const uint32_t* s_w, int r) {
  return __funnelshift_r(s_w[r >> 2], s_w[(r >> 2) + 1], 8 * (r & 3));
}

// The mechanically decoded code point of the lead in the low byte of X
// (the lead, then the three bytes after it), as ops/utf8.classify's
// ``cp``, branch-free: the lead's payload and three continuations' six
// bits make t; the lead's leading ones (its sequence length) say how much
// of t is the code point; 0 for F8-FF. Never called on a continuation
// byte.
__device__ __forceinline__ uint32_t lead_cp(uint32_t X) {
  const int k = __clz(~(X << 24));  // leading ones of the lead
  const uint32_t t = ((X & (0x7Fu >> k)) << 18) | ((X >> 8 & 0x3F) << 12) |
                     ((X >> 16 & 0x3F) << 6) | (X >> 24 & 0x3F);
  return k > 4 ? 0u : t >> (24 - 6 * (k > 1 ? k : 1));
}

}  // namespace su
