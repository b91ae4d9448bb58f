// Three bodies of simdutf_tpu/kernels/butterflyx._run_phase_b, each as two
// launches with a little torch glue between them, on the shared skeleton of
// emitx.cuh:
//
//   utf32_to_utf8_compose  - the _kernel_u32_to_u8 body, with the byte
//     placement of butterfly16._phase_c16 that
//     butterflyx.u32_to_utf8_compose reuses: the general (mixed-width)
//     validating UTF-32 -> UTF-8 transcode. Each in-range word emits 1-4
//     bytes as ops/utf32._emit_utf8 does (a word above 0x10FFFF the one
//     byte 0x00, a surrogate its 3 bytes).
//   utf32_to_utf16_compose - the _kernel_u32_to_u16 body, with the unit
//     placement of butterflyx._phase_c_u16: each in-range word emits
//     1 + (cp > 0xFFFF) units as ops/utf32._emit_utf16 does (cp = 0 above
//     0x10FFFF, so such a word emits the one unit 0x0000; a surrogate word
//     emits itself), byte-swapped for BE. Staging the tile's units in
//     shared memory and storing them contiguously at the tile's offset is
//     what _phase_c_u16 does with its roll/merge grid over candidate tiles.
//   latin1_to_utf8_compose - the _kernel_l1_to_u8 body, with phase C16's
//     placement (butterflyx.latin1_to_utf8_compose): 1 byte per byte below
//     0x80, 2 above. Latin-1 has no invalid input, so there is no event.
//
// The UTF-32 count passes also reduce the least error key (pos << 8 |
// TOO_LARGE or SURROGATE) and the units before it. The JAX package's
// scatter engines (ops/utf32.to_utf8 and .to_utf16) leave every word's
// output in place past out_len, and the TPU butterflies' err_any rerun of
// them gives the same final buffer; the emit passes give it directly.
//
// Floor: HBM bytes, two reads of the input (count and emit passes) and one
// write of the output. The TPU compacts candidate planes per tile with
// roll/select butterflies because its scatter was slow; here a block scan
// gives each element its output slot, and staging in shared memory turns
// each thread's scattered stores into contiguous warp stores.
#include "emitx.cuh"
#include "utf16.cuh"
#include "utf32.cuh"

namespace {

// the words of a UTF-32 buffer and their TOO_LARGE / SURROGATE events
struct Utf32Words {
  using Elem = int;
  static constexpr bool EVENTS = true;
  static __device__ __forceinline__ void load8(const int* __restrict__ w,
                                               long long p0, long long length,
                                               int v[8]) {
    su::load_words8(w, p0, length, su::aligned16w(w), v);
  }
  static __device__ __forceinline__ bool bad(int w) { return su::bad32(w); }
  static __device__ __forceinline__ int code(int w) {
    return su::too_large32(w) ? su::TOO_LARGE : su::SURROGATE;
  }
};

struct Utf32ToUtf8 : Utf32Words {
  using Out = uint8_t;
  static constexpr int MAX_OUT = 4;
  static __device__ __forceinline__ int width(int w) {
    return su::utf8_width(su::emit_cp32(w));
  }
  static __device__ __forceinline__ int put(int w, uint8_t* d) {
    const int cp = su::emit_cp32(w);
    if (cp < 0x80) {
      d[0] = cp;
      return 1;
    }
    if (cp < 0x800) {
      d[0] = 0xC0 | (cp >> 6);
      d[1] = 0x80 | (cp & 0x3F);
      return 2;
    }
    if (cp < 0x10000) {
      d[0] = 0xE0 | (cp >> 12);
      d[1] = 0x80 | ((cp >> 6) & 0x3F);
      d[2] = 0x80 | (cp & 0x3F);
      return 3;
    }
    d[0] = 0xF0 | (cp >> 18);
    d[1] = 0x80 | ((cp >> 12) & 0x3F);
    d[2] = 0x80 | ((cp >> 6) & 0x3F);
    d[3] = 0x80 | (cp & 0x3F);
    return 4;
  }
};

template <bool BE>
struct Utf32ToUtf16 : Utf32Words {
  using Out = uint16_t;
  static constexpr int MAX_OUT = 2;
  static __device__ __forceinline__ int width(int w) {
    return 1 + (su::emit_cp32(w) > 0xFFFF);
  }
  static __device__ __forceinline__ int put(int w, uint16_t* d) {
    const int cp = su::emit_cp32(w);
    if (cp > 0xFFFF) {
      const int cpx = cp - 0x10000;
      const int hi = 0xD800 + (cpx >> 10), lo = 0xDC00 + (cpx & 0x3FF);
      d[0] = BE ? su::bswap16(hi) : hi;
      d[1] = BE ? su::bswap16(lo) : lo;
      return 2;
    }
    d[0] = BE ? su::bswap16(cp) : cp;
    return 1;
  }
};

struct Latin1ToUtf8 {
  using Elem = uint8_t;
  using Out = uint8_t;
  static constexpr int MAX_OUT = 2;
  static constexpr bool EVENTS = false;
  // v[j] = byte p0 + j, zero at/after length; one 8-byte load when the
  // chunk is whole and the buffer base 8-byte aligned
  static __device__ __forceinline__ void load8(const uint8_t* __restrict__ b,
                                               long long p0, long long length,
                                               int v[8]) {
    if ((reinterpret_cast<uintptr_t>(b) & 7) == 0 && p0 + 8 <= length) {
      const uint2 m = *reinterpret_cast<const uint2*>(b + p0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (m.x >> (8 * j)) & 0xFF;
        v[4 + j] = (m.y >> (8 * j)) & 0xFF;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = p0 + j < length ? b[p0 + j] : 0;
    }
  }
  static __device__ __forceinline__ int width(int x) { return 1 + (x >= 0x80); }
  static __device__ __forceinline__ int put(int x, uint8_t* d) {
    if (x < 0x80) {
      d[0] = x;
      return 1;
    }
    d[0] = 0xC0 | (x >> 6);
    d[1] = 0x80 | (x & 0x3F);
    return 2;
  }
};

template <class E>
int count(const typename E::Elem* src, long long length, int nt, int* counts,
          unsigned long long* keys, int* prefix, void* stream) {
  su::emitx_count_kernel<E><<<nt, su::EMITX_THREADS, 0, (cudaStream_t)stream>>>(
      src, length, counts, keys, prefix);
  return (int)cudaGetLastError();
}

template <class E>
int emit(const typename E::Elem* src, long long length, int nt,
         const long long* off, typename E::Out* out, void* stream) {
  su::emitx_emit_kernel<E><<<nt, su::EMITX_THREADS, 0, (cudaStream_t)stream>>>(
      src, length, off, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Count passes over nt = ceil(length / 2048) tiles: per tile the output
// count, and for UTF-32 input the least event key (BIG << 8 when none) and
// the output before that event. Emit passes: tile t's output goes to
// out[off[t] + i]; the rest of `out` is left as the caller zeroed it. Each
// returns cudaGetLastError().
extern "C" int composex_count(const int* w, long long length, int nt,
                              int* counts, unsigned long long* keys,
                              int* prefix, void* stream) {
  return count<Utf32ToUtf8>(w, length, nt, counts, keys, prefix, stream);
}

extern "C" int composex_emit(const int* w, long long length, int nt,
                             const long long* off, uint8_t* out,
                             void* stream) {
  return emit<Utf32ToUtf8>(w, length, nt, off, out, stream);
}

extern "C" int u32_to_u16_count(const int* w, long long length, int nt,
                                int* counts, unsigned long long* keys,
                                int* prefix, void* stream) {
  return count<Utf32ToUtf16<false>>(w, length, nt, counts, keys, prefix, stream);
}

// units byte-swapped when be
extern "C" int u32_to_u16_emit(const int* w, long long length, int be, int nt,
                               const long long* off, uint16_t* out,
                               void* stream) {
  return be ? emit<Utf32ToUtf16<true>>(w, length, nt, off, out, stream)
            : emit<Utf32ToUtf16<false>>(w, length, nt, off, out, stream);
}

extern "C" int latin1_utf8_count(const uint8_t* b, long long length, int nt,
                                 int* counts, void* stream) {
  return count<Latin1ToUtf8>(b, length, nt, counts, nullptr, nullptr, stream);
}

extern "C" int latin1_utf8_emit(const uint8_t* b, long long length, int nt,
                                const long long* off, uint8_t* out,
                                void* stream) {
  return emit<Latin1ToUtf8>(b, length, nt, off, out, stream);
}
