// Fixed-rate UTF-8 <-> UTF-16 transcodes of one census class each, with
// the Pallas kernels' class flag ("some in-range element lies outside the
// class"):
//   utf8_to_utf16_fixed<ASCII | U2 | U3 | U4, BE> replaces _widen_kernel
//     (simdutf_tpu/kernels/transcode.py ascii_widen_utf16, pallas_call
//     :82), _uniform2_kernel (uniform2_utf8_to_utf16, :211),
//     _uniform3_kernel (_uniform3_pallas, :312) and _wordmap_kernel's
//     "u8_to_u16" variant (astral_wordmap, :1127: 4 bytes -> one
//     surrogate pair);
//   utf16_to_utf8_fixed<ASCII | U2, BE> replaces _narrow_kernel
//     (ascii_narrow_utf8, :133) and _rev2_kernel (uniform2_utf16_to_utf8,
//     :385);
//   narrow3<BE> replaces _rev3_kernel (_rev3_pallas, :472): see there.
//
// Floor: HBM bytes, one read of the in-range input and one write of the
// whole output buffer (3 bytes per input byte for the widen family, 2 + 3
// per unit for the narrow one). In the grid-stride kernels each thread
// step is one to three 16-byte loads and stores: 16 bytes -> 16 units
// (ASCII), 16 bytes -> 8 units (U2, U4), 48 bytes -> 16 units (U3); 16
// units -> 16 bytes, 8 units -> 16 bytes. 48 is a multiple of 16, so every
// access of a 16-byte aligned buffer stays aligned; a ragged last step, or
// a buffer that is not aligned, takes byte accesses.
//
// Where the TPU kernels lean on zero padding and a host trim, these take
// the length: elements at/after it read as zero and never flag (a
// character whose first byte is in range is checked with them, as the
// Pallas kernels check it against their zero padding), and the kernels
// write the whole output buffer, the class's output then zeros, in the
// same pass (no separate fill). The TPU grid carries the flag in one SMEM
// word across its sequential steps; here every block ORs its threads'
// flags with __syncthreads_or and makes one atomicOr. Output offsets are
// 64-bit: 3n bytes exceed 2^31 for buffers above 2^31 / 3 units.
#include "bulk.cuh"
#include "utf16.cuh"

namespace {

constexpr int ASCII = 1, U2 = 2, U3 = 3, U4 = 4;  // UTF-8 bytes a character

// w[i] = the 4 bytes at p0 + 4i for i in [0, 4K), zero at/after lim
template <int K>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ b,
                                           long long p0, long long lim,
                                           bool vec, uint32_t (&w)[4 * K]) {
  if (vec && p0 + 16 * K <= lim) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint4 m = reinterpret_cast<const uint4*>(b + p0)[i];
      w[4 * i] = m.x;
      w[4 * i + 1] = m.y;
      w[4 * i + 2] = m.z;
      w[4 * i + 3] = m.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * K; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long q = p0 + 4 * i + j;
        if (q < lim) v |= (uint32_t)b[q] << (8 * j);
      }
      w[i] = v;
    }
  }
}

// the 16K bytes of w to out + o0; bytes at/after lim are dropped
template <int K>
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ out,
                                            long long o0, long long lim,
                                            bool vec,
                                            const uint32_t (&w)[4 * K]) {
  if (vec && o0 + 16 * K <= lim) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      reinterpret_cast<uint4*>(out + o0)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < 16 * K; ++i)
      if (o0 + i < lim) out[o0 + i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

template <int N>
__device__ __forceinline__ int byte_at(const uint32_t (&w)[N], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
}

// out: n units; units [0, length / CLS * UPC) decoded, the rest zero (UPC:
// units per character, 2 for the 4-byte class's surrogate pair)
template <int CLS, bool BE>
__global__ void __launch_bounds__(256)
    utf8_to_utf16_fixed(const uint8_t* __restrict__ b, long long n,
                        long long length, uint8_t* __restrict__ out,
                        int* __restrict__ flag) {
  constexpr int UPC = CLS == U4 ? 2 : 1;
  constexpr int CH = CLS == U2 ? 8 : CLS == U4 ? 4 : 16;  // chars per step
  constexpr int UNITS = CH * UPC;                          // units per step
  constexpr int KIN = CH * CLS / 16, KOUT = UNITS * 2 / 16;
  const bool vec = su::aligned16(b) && su::aligned16(out);
  const long long cnt = length / CLS * UPC, steps = (n + UNITS - 1) / UNITS;
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long p0 = k * CH * CLS, q0 = k * UNITS;
    uint32_t o[4 * KOUT] = {};
    if (p0 < length) {
      uint32_t x[4 * KIN];
      load_bytes<KIN>(b, p0, length, vec, x);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c0 = byte_at(x, CLS * j);
        int u[UPC];
        bool ok;
        if constexpr (CLS == ASCII) {
          u[0] = c0;
          ok = c0 < 0x80;
        } else if constexpr (CLS == U2) {
          const int c1 = byte_at(x, 2 * j + 1);
          u[0] = ((c0 & 0x1F) << 6) | (c1 & 0x3F);
          ok = (c0 & 0xE0) == 0xC0 && c0 >= 0xC2 && su::is_cont(c1);
        } else if constexpr (CLS == U3) {
          // _u8_3byte_char: structure, overlong and surrogate checks
          const int c1 = byte_at(x, 3 * j + 1), c2 = byte_at(x, 3 * j + 2);
          u[0] = ((c0 & 0x0F) << 12) | ((c1 & 0x3F) << 6) | (c2 & 0x3F);
          ok = (c0 & 0xF0) == 0xE0 && su::is_cont(c1) && su::is_cont(c2) &&
               u[0] >= 0x800 && !su::is_sur(u[0]);
        } else {  // _u8_4byte_cp: structure and range; then _astral_pair
          const int c1 = byte_at(x, 4 * j + 1), c2 = byte_at(x, 4 * j + 2),
                    c3 = byte_at(x, 4 * j + 3);
          const int cp = ((c0 & 0x07) << 18) | ((c1 & 0x3F) << 12) |
                         ((c2 & 0x3F) << 6) | (c3 & 0x3F);
          ok = su::is_lead4(c0) && su::is_cont(c1) && su::is_cont(c2) &&
               su::is_cont(c3) && cp >= 0x10000 && cp <= 0x10FFFF;
          u[0] = 0xD7C0 + (cp >> 10);  // 0xD800 + ((cp - 0x10000) >> 10)
          u[1] = 0xDC00 + (cp & 0x3FF);
        }
        bad |= !ok && p0 + CLS * j < length;
#pragma unroll
        for (int i = 0; i < UPC; ++i) {
          const int at = UPC * j + i;
          int v = q0 + at < cnt ? u[i] : 0;
          if (BE) v = su::bswap16(v);
          o[at >> 1] |= (uint32_t)v << (16 * (at & 1));
        }
      }
    }
    store_bytes<KOUT>(out, 2 * q0, 2 * n, vec, o);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// out: 3n bytes; bytes [0, CLS * length) encoded, the rest zero. The ASCII
// class keeps each unit's low byte (u & 0xFF), as the plain branch does.
template <int CLS, bool BE>
__global__ void __launch_bounds__(256)
    utf16_to_utf8_fixed(const uint8_t* __restrict__ w, long long n,
                        long long length, uint8_t* __restrict__ out,
                        int* __restrict__ flag) {
  static_assert(CLS == ASCII || CLS == U2, "the U3 class runs narrow3");
  constexpr int UNITS = CLS == U2 ? 8 : 16;  // input units per step
  constexpr int KIN = UNITS * 2 / 16, KOUT = UNITS * CLS / 16;
  const bool vec = su::aligned16(w) && su::aligned16(out);
  const long long steps = (3 * n + UNITS * CLS - 1) / (UNITS * CLS);
  bool bad = false;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    const long long q0 = k * UNITS;
    uint32_t o[4 * KOUT] = {};
    if (q0 < length) {
      uint32_t x[4 * KIN];
      load_bytes<KIN>(w, 2 * q0, 2 * length, vec, x);
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        int u = (x[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
        if (BE) u = su::bswap16(u);
        const bool in = q0 + j < length;
        int by[CLS];
        bool ok;
        if constexpr (CLS == ASCII) {
          ok = u < 0x80;
          by[0] = u & 0xFF;
        } else {
          ok = u >= 0x80 && u <= 0x7FF;
          by[0] = ((u >> 6) | 0xC0) & 0xFF;
          by[1] = (u & 0x3F) | 0x80;
        }
        bad |= !ok && in;
        if (in) {
#pragma unroll
          for (int i = 0; i < CLS; ++i) {
            const int at = CLS * j + i;
            o[at >> 2] |= (uint32_t)by[i] << (8 * (at & 3));
          }
        }
      }
    }
    store_bytes<KOUT>(out, k * UNITS * CLS, 3 * n, vec, o);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// --- narrow3: the U3 class, UTF-16 -> UTF-8, through the copy engine -----
//
// Replaces _rev3_kernel behind _rev3_pallas (simdutf_tpu/kernels/
// transcode.py:472). Each unit becomes 3 bytes (the class flag: a unit
// below 0x800 or a surrogate): 5 bytes moved a unit, 60% of them output,
// and a few integer operations, so HBM sets the pace. A grid-stride thread
// step of 16 units stores 48 bytes as three 16-byte stores 48 bytes apart
// across the warp, which reached about half the HBM rate; here no thread
// touches device memory on the tiles.
//
// A persistent grid of one wave walks whole tiles of N3_TILE units on
// bulk.cuh's tile_ring, as widen32 (transcode32.cu) does: a ring of
// N3_STAGES stages, each an 8 KiB input tile and a 12 KiB output tile;
// thread 0 keeps the next stages' input in flight with bulk loads on the
// stages' mbarriers and writes each output tile with one evict-first bulk
// store. Thread t encodes units [16t, 16t + 16) of a tile: two 16-byte
// shared loads (the lanes of each quarter-warp take their two halves in
// opposite orders, so the eight loads of a phase hit eight different
// 16-byte bank groups) and three 16-byte shared stores 48 bytes apart (the
// eight stores of a phase land on eight different bank groups). A tile
// wholly at or past the length loads nothing and writes zeros.
//
// The edges take the element path in the same kernel, steps of up to 16
// units (byte accesses where a step is off the 16-byte grid): the head
// before the first unit whose input and output both lie on the grid, the
// units after the last whole tile, and every unit when no such unit
// exists (or fewer than a tile follow it). The host computes the split
// from the two addresses (narrow3_split; kernels/transcode.narrow3_split is
// its twin).
constexpr int N3_THREADS = 256;
constexpr int N3_TILE = 4096;   // units a tile: 8 KiB in, 12 KiB out
constexpr int N3_STAGES = 3;
constexpr int N3_SMEM = N3_STAGES * 5 * N3_TILE;  // dynamic shared memory a block

// the 3 UTF-8 bytes of unit u, the first lowest
__device__ __forceinline__ uint32_t enc3(uint32_t u) {
  return (0xE0 | u >> 12) | (0x80 | (u >> 6 & 0x3F)) << 8 | (0x80 | (u & 0x3F)) << 16;
}

// 16 units (x: 32 bytes in storage order) to 48 bytes (o); units at or
// after `live` give zero bytes and never flag. Returns the flag.
template <bool BE>
__device__ __forceinline__ bool encode16(const uint32_t (&x)[8], long long live,
                                         uint32_t (&o)[12]) {
  bool bad = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // four units -> three words
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      int u = (x[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
      if (BE) u = su::bswap16(u);
      const bool in = j < live;
      bad |= in && (u < 0x800 || su::is_sur(u));
      e[i] = in ? enc3(u) : 0u;
    }
    o[3 * q] = e[0] | e[1] << 24;
    o[3 * q + 1] = e[1] >> 8 | e[2] << 16;
    o[3 * q + 2] = e[2] >> 16 | e[3] << 8;
  }
  return bad;
}

// the element path: units [q0, hi) (at most 16) to bytes [3 q0, 3 hi)
template <bool BE>
__device__ __forceinline__ bool narrow3_step(const uint8_t* __restrict__ w,
                                             long long q0, long long hi,
                                             long long length,
                                             uint8_t* __restrict__ out) {
  const long long lim = hi < length ? hi : length;
  const bool vec = su::aligned16(w + 2 * q0) && su::aligned16(out + 3 * q0);
  uint32_t x[8], o[12];
  load_bytes<2>(w, 2 * q0, 2 * lim, vec, x);
  const bool bad = encode16<BE>(x, lim - q0, o);
  store_bytes<3>(out, 3 * q0, 3 * hi, vec, o);
  return bad;
}

// one tile from shared `in` (N3_TILE units) to shared `ot` (3 N3_TILE
// bytes); `live` units of it lie before the length
template <bool BE>
__device__ __forceinline__ bool narrow3_tile(const uint8_t* in, uint8_t* ot,
                                             long long live) {
  const int tid = threadIdx.x;
  const int sw = (tid >> 2) & 1;
  const uint4* i4 = reinterpret_cast<const uint4*>(in) + 2 * tid;
  const uint4 a = i4[sw], b = i4[1 - sw];
  const uint4 lo = sw ? b : a, hi = sw ? a : b;
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t o[12];
  const bool bad = encode16<BE>(x, live - 16 * tid, o);
  uint4* o4 = reinterpret_cast<uint4*>(ot) + 3 * tid;
#pragma unroll
  for (int i = 0; i < 3; ++i) o4[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  return bad;
}

// out: 3n bytes; bytes [0, 3 length) encoded, the rest zero. Units [head,
// head + ntiles * N3_TILE) go by tiles (w + 2 head and out + 3 head
// 16-byte aligned), the rest by element steps.
template <bool BE>
__global__ void __launch_bounds__(N3_THREADS)
    narrow3(const uint8_t* __restrict__ w, long long n, long long length,
            uint8_t* __restrict__ out, int* __restrict__ flag, long long head,
            long long ntiles) {
  extern __shared__ __align__(128) uint8_t smem[];
  bool bad = false;
  // the edges: [0, head) as one step, then [tail, n) in steps of 16
  const long long tail = head + ntiles * N3_TILE, hs = head > 0;
  const long long edge = hs + (n - tail + 15) / 16;
  for (long long e = blockIdx.x * (long long)N3_THREADS + threadIdx.x; e < edge;
       e += (long long)gridDim.x * N3_THREADS) {
    const long long q0 = e < hs ? 0 : tail + 16 * (e - hs);
    const long long hi = e < hs ? head : (q0 + 16 < n ? q0 + 16 : n);
    bad |= narrow3_step<BE>(w, q0, hi, length, out);
  }
  // the tiles
  bad |= su::tile_ring<N3_STAGES, N3_TILE, 2 * N3_TILE, 3 * N3_TILE, N3_THREADS>(
      w + 2 * head, out + 3 * head, ntiles, length - head, smem,
      [](const uint8_t* in, uint8_t* ot, long long live) {
        return narrow3_tile<BE>(in, ot, live);
      });
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// The split of n units at w (output at out) between the element path and
// the tiles: head = the first unit with w + 2 head and out + 3 head on the
// 16-byte grid, if a whole tile follows it, and ntiles = the whole tiles
// after it; else head = ntiles = 0 (every unit by steps).
void narrow3_split(const void* w, long long n, const void* out, long long* head,
                   long long* ntiles) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w), o = reinterpret_cast<uintptr_t>(out);
  *head = 0;
  *ntiles = 0;
  for (long long h = 0; h < 16; ++h)
    if (((a + 2 * h) & 15) == 0 && ((o + 3 * h) & 15) == 0) {
      if (n - h >= N3_TILE) {
        *head = h;
        *ntiles = (n - h) / N3_TILE;
      }
      return;
    }
}

// blocks of narrow3<BE> resident on one SM of the current device (its
// shared memory allowed first), and that device's SMs
template <bool BE>
cudaError_t narrow3_resident(int* per_sm, int* sms) {
  static int cached[64];  // by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev]) {
    *per_sm = cached[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(narrow3<BE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           N3_SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, narrow3<BE>,
                                                      N3_THREADS, N3_SMEM);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = *per_sm;
  return cudaSuccess;
}

// grid of a call: enough blocks for the tiles or the edge steps, at most
// one wave
long long narrow3_grid(long long n, long long head, long long ntiles, int per_sm,
                       int sms) {
  const long long edge = (head > 0) + (n - head - ntiles * N3_TILE + 15) / 16;
  const long long edge_blocks = (edge + N3_THREADS - 1) / N3_THREADS;
  long long grid = ntiles > edge_blocks ? ntiles : edge_blocks;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  return grid < 1 ? 1 : grid;
}

template <bool BE>
int narrow3_launch(const uint16_t* w, long long n, long long length,
                   uint8_t* out, int* flag, void* stream) {
  int per_sm = 0, sms = 0;
  const cudaError_t e = narrow3_resident<BE>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  long long head, ntiles;
  narrow3_split(w, n, out, &head, &ntiles);
  narrow3<BE><<<(int)narrow3_grid(n, head, ntiles, per_sm, sms), N3_THREADS, N3_SMEM,
                (cudaStream_t)stream>>>(reinterpret_cast<const uint8_t*>(w), n,
                                        length, out, flag, head, ntiles);
  return (int)cudaGetLastError();
}

template <int CLS>
int widen(const uint8_t* b, long long n, long long length, int be,
          uint16_t* out, int* flag, void* stream) {
  const int grid = su::grid_for((n + 15) / 16);
  auto* o = reinterpret_cast<uint8_t*>(out);
  if (be)
    utf8_to_utf16_fixed<CLS, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        b, n, length, o, flag);
  else
    utf8_to_utf16_fixed<CLS, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        b, n, length, o, flag);
  return (int)cudaGetLastError();
}

template <int CLS>
int narrow(const uint16_t* w, long long n, long long length, int be,
           uint8_t* out, int* flag, void* stream) {
  const int grid = su::grid_for((3 * n + 47) / 48);
  auto* x = reinterpret_cast<const uint8_t*>(w);
  if (be)
    utf16_to_utf8_fixed<CLS, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, out, flag);
  else
    utf16_to_utf8_fixed<CLS, false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        x, n, length, out, flag);
  return (int)cudaGetLastError();
}

}  // namespace

// b: n bytes, out: n units, flag: one zeroed int32 on the device. Returns
// cudaGetLastError().
extern "C" int ascii_widen_utf16(const uint8_t* b, long long n,
                                 long long length, int be, uint16_t* out,
                                 int* flag, void* stream) {
  return widen<ASCII>(b, n, length, be, out, flag, stream);
}

extern "C" int uniform2_utf8_to_utf16(const uint8_t* b, long long n,
                                      long long length, int be, uint16_t* out,
                                      int* flag, void* stream) {
  return widen<U2>(b, n, length, be, out, flag, stream);
}

extern "C" int uniform3_utf8_to_utf16(const uint8_t* b, long long n,
                                      long long length, int be, uint16_t* out,
                                      int* flag, void* stream) {
  return widen<U3>(b, n, length, be, out, flag, stream);
}

extern "C" int astral_utf8_to_utf16(const uint8_t* b, long long n,
                                    long long length, int be, uint16_t* out,
                                    int* flag, void* stream) {
  return widen<U4>(b, n, length, be, out, flag, stream);
}

// w: n units, out: 3n bytes, flag: one zeroed int32 on the device. Returns
// cudaGetLastError().
extern "C" int ascii_narrow_utf8(const uint16_t* w, long long n,
                                 long long length, int be, uint8_t* out,
                                 int* flag, void* stream) {
  return narrow<ASCII>(w, n, length, be, out, flag, stream);
}

extern "C" int uniform2_utf16_to_utf8(const uint16_t* w, long long n,
                                      long long length, int be, uint8_t* out,
                                      int* flag, void* stream) {
  return narrow<U2>(w, n, length, be, out, flag, stream);
}

extern "C" int uniform3_utf16_to_utf8(const uint16_t* w, long long n,
                                      long long length, int be, uint8_t* out,
                                      int* flag, void* stream) {
  return be ? narrow3_launch<true>(w, n, length, out, flag, stream)
            : narrow3_launch<false>(w, n, length, out, flag, stream);
}

// The launch plan of uniform3_utf16_to_utf8 for n units at w into out on
// the current device: plan[0..7] = grid, threads a block, blocks a SM,
// units a tile, stages, shared memory bytes a block, head, whole tiles
// (narrow3_split). Launches nothing; returns a cudaError_t.
extern "C" int narrow3_plan(const void* w, long long n, const void* out,
                            long long* plan) {
  int per_sm = 0, sms = 0;
  const cudaError_t e = narrow3_resident<false>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  long long head, ntiles;
  narrow3_split(w, n, out, &head, &ntiles);
  plan[0] = narrow3_grid(n, head, ntiles, per_sm, sms);
  plan[1] = N3_THREADS;
  plan[2] = per_sm;
  plan[3] = N3_TILE;
  plan[4] = N3_STAGES;
  plan[5] = N3_SMEM;
  plan[6] = head;
  plan[7] = ntiles;
  return 0;
}
