// lane_shapecast_probe: the function of the inline probe kernel ``k`` in
// simdutf_tpu/kernels/validate.lane_shapecast_supported (its Mosaic
// capability probe): x ^ salt, then per quad q0..q3 the lanes
// a = q0 ^ q3, b = q1 ^ q2, a, b (the k=4 split, the k=2 interleave and
// split, and the k=4 interleave of a (64, 512) int32 tile).
//
// On the TPU the reshapes are the point: some toolchains reject them. On
// Hopper the function is a per-quad map, one thread per quad with a
// 16-byte load and store. At the probe's one tile (128 KiB) it is bound by
// the launch, not by its 256 KiB of traffic.
#include "utf8.cuh"  // grid_for

namespace {

__global__ void __launch_bounds__(256)
    probe_kernel(const int4* __restrict__ x, long long quads, int salt,
                 int4* __restrict__ out) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       k < quads; k += (long long)gridDim.x * blockDim.x) {
    const int4 q = x[k];
    const int a = (q.x ^ salt) ^ (q.w ^ salt);
    const int b = (q.y ^ salt) ^ (q.z ^ salt);
    out[k] = make_int4(a, b, a, b);
  }
}

}  // namespace

// x, out: int32 arrays of 4 * quads elements, 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int lane_shapecast_probe(const int* x, long long quads, int salt,
                                    int* out, void* stream) {
  probe_kernel<<<su::grid_for(quads), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(x), quads, salt, reinterpret_cast<int4*>(out));
  return (int)cudaGetLastError();
}
