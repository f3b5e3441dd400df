// Per-Gaussian gradient sum after the compositing backward, in a fixed
// order (sm_90a).
//
// Replaces the per-Gaussian reduction of _composite_bwd in
// freesurgs_tpu/ops/raster_pallas.py (the fast binner's fixed-order sum:
// a cumsum over each Gaussian's contiguous run and two prefix lookups,
// :737-756), which K2 (composite_bwd.cu) leaves outside. In the port it
// replaces index_add_, whose float atomics sum a Gaussian's instances in
// an order that varies from run to run.
//
// Inputs: dfeat (10, M), K2's gradient per instance slot and field;
// order (M,) int32, the slots stably sorted by the Gaussian they hold
// (made once per binning and carried with the layout, ops/binning.py), so
// a Gaussian's slots form one run in ascending slot order; start (n + 1,)
// int32, where Gaussian g's run begins (start[n] = the first padding
// slot). Output: out (n, 10), row g the sum of its run, field by field.
//
// One thread per Gaussian walks its run front to back with ten float
// accumulators starting from 0, so each sum is taken in ascending slot
// order: the order of index_add_ on the CPU and of the plain version's
// rank loop, bit for bit. Deterministic, no atomics.
//
// What bounds it on an H100: the bytes (dfeat read once, 40 B a slot; the
// order, 4 B a slot; out written once), against 3.35 TB/s; the adds are
// ~10 per slot. The reads of dfeat are gathers through order, scattered
// across a Gaussian's tiles, and neighbouring threads walk runs of
// unequal length; a later design could sort by run length or split long
// runs.

#include <cuda_runtime.h>

namespace {

constexpr int NF = 10;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gaussian_grad_sum_kernel(const float* __restrict__ dfeat,
                         const int* __restrict__ order,
                         const int* __restrict__ start,
                         float* __restrict__ out, int n, int m) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= n) return;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.0f;
  const int j1 = start[g + 1];
  for (int j = start[g]; j < j1; ++j) {
    const int s = order[j];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] += dfeat[(long long)f * m + s];
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) out[(long long)g * NF + f] = acc[f];
}

}  // namespace

extern "C" int gaussian_grad_sum(const float* dfeat, const int* order,
                                 const int* start, float* out, int n, int m,
                                 void* stream) {
  if (n > 0) {
    gaussian_grad_sum_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                               (cudaStream_t)stream>>>(dfeat, order, start,
                                                       out, n, m);
  }
  return (int)cudaGetLastError();
}
