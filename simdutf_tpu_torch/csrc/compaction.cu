// row_compact: stable per-row compaction by a keep mask (replaces the
// Pallas kernel _compact_kernel behind
// simdutf_tpu/kernels/compaction.row_compact_pallas, math _row_compact).
// out[r, j] is the j-th kept value of row r, 0 beyond the row's count;
// counts[r] is the number kept.
//
// The TPU forms each output slot by a Hillis-Steele scan with masked rolls
// and a log2(W)-step binary search of lane gathers, because Mosaic's
// scatter serialised and its dynamic gather spans one 128-lane vreg. On
// Hopper a block takes one row: a block-wide exclusive scan of the keep
// flags (warp shuffles, then the warp totals) gives each kept value its
// slot directly, a loop over blockDim-wide chunks carries the running
// count for wide rows, and a strided loop zero-fills the rest of the row.
// Floor: HBM bytes (val and keep read once, out and counts written once);
// at W = 128 a block of 128 threads has little to hide its latency behind.
#include "utf8.cuh"  // block_excl_scan

namespace {

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    compact_kernel(const int* __restrict__ val, const int* __restrict__ keep,
                   int width, int* __restrict__ out, int* __restrict__ counts) {
  __shared__ int s_scan[THREADS / 32];
  const long long row = (long long)blockIdx.x * width;
  int count = 0;  // kept values of the chunks before this one
  for (int base = 0; base < width; base += THREADS) {
    const int j = base + threadIdx.x;
    const int k = j < width && keep[row + j] != 0;
    int total;
    const int rank = su::block_excl_scan<THREADS / 32>(k, s_scan, &total);
    if (k) out[row + count + rank] = val[row + j];
    count += total;
  }
  for (int j = count + threadIdx.x; j < width; j += THREADS) out[row + j] = 0;
  if (threadIdx.x == 0) counts[blockIdx.x] = count;
}

template <int THREADS>
int launch(const int* val, const int* keep, long long rows, int width, int* out,
           int* counts, void* stream) {
  compact_kernel<THREADS><<<(unsigned)rows, THREADS, 0, (cudaStream_t)stream>>>(
      val, keep, width, out, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// val, keep: (rows, width) int32, row-major; out: (rows, width) int32;
// counts: rows int32. width is a power of two (the wrapper checks); a
// block of min(max(width, 32), 256) threads per row. Returns
// cudaGetLastError().
extern "C" int row_compact(const int* val, const int* keep, long long rows,
                           int width, int* out, int* counts, void* stream) {
  if (width <= 32) return launch<32>(val, keep, rows, width, out, counts, stream);
  if (width == 64) return launch<64>(val, keep, rows, width, out, counts, stream);
  if (width == 128) return launch<128>(val, keep, rows, width, out, counts, stream);
  return launch<256>(val, keep, rows, width, out, counts, stream);
}
