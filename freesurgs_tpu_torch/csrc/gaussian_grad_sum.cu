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
// Inputs: dsum (M, 10), K2's gradients per instance slot, stored in sum
// order: slot s in row sum_rank[s] (ops/binning.py sum_layout), so
// Gaussian g's slots are the contiguous rows [start[g], start[g + 1]), in
// ascending slot order, and padding slots lie past start[n]; start
// (n + 1,) int32; init (n, 10) or null. Output: out (n, 10), row g the sum
// of its rows, field by field, added to init's row g when there is one.
//
// Each thread owns one Gaussian and adds its rows front to back into ten
// float accumulators starting from 0 (or from init), so each sum is taken
// in ascending slot order: the order of index_add_ on the CPU and of the
// plain version's rank loop, bit for bit. Deterministic, no atomics. A sum
// seeded with another layout's sums continues them: a band of a
// band-sharded render (parallel/sharded.py) seeds its sums with the bands
// above it, so the total is the single-image sum, bit for bit.
//
// What bounds it on an H100: the bytes (dsum's rows of the runs read once,
// 40 B a slot; start read and out written once), against 3.35 TB/s; the
// adds are 10 a slot. The first design read K2's field-major (10, M)
// output through the sorted slot order: ten 4 B gathers a slot, each in a
// 32 B sector of its own (~324 B of sector traffic for 40 B used), which
// held it to ~0.13 of the bound. With the rows in sum order, a block's 256
// Gaussians own one contiguous span of rows. A thread walking its own rows
// in device memory still spread each warp's loads over ~25 lines an
// instruction, so the block stages its span instead: every thread copies
// neighbouring 8 B pieces of it into shared memory by cp.async (no
// register round trip, all in flight together), in windows of 1024 rows
// (40 KB), and each thread then walks its run there. Runs are short (a
// Gaussian covers a few bin tiles) and the walk in shared memory is cheap,
// so their unequal lengths cost little, and a run longer than a window
// continues in the next one, in order. The block's 256 output rows leave
// through the same buffer as one contiguous, coalesced store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 10;
constexpr int H = NF / 2;              // 8 B pieces of a row
constexpr int THREADS = 256;
constexpr int WROWS = 1024;            // rows staged a window (40 KB)

__device__ inline void copy8_async(float2* dst, const float2* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
gaussian_grad_sum_kernel(const float2* __restrict__ dsum,
                         const int* __restrict__ start,
                         const float2* __restrict__ init,
                         float2* __restrict__ out, int n) {
  __shared__ float2 win[WROWS * H];
  const int g0 = blockIdx.x * THREADS;
  const int g = g0 + threadIdx.x;
  const int g_end = min(g0 + THREADS, n);
  const int span_end = start[g_end];
  int j = g < n ? start[g] : span_end;          // this thread's run
  const int j1 = g < n ? start[g + 1] : span_end;
  float acc[NF];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float2 v = init != nullptr && g < n ? init[(size_t)g * H + h]
                                              : make_float2(0.0f, 0.0f);
    acc[2 * h] = v.x;
    acc[2 * h + 1] = v.y;
  }

  for (int w0 = start[g0]; w0 < span_end; w0 += WROWS) {
    const int pieces = min(WROWS, span_end - w0) * H;
    const float2* src = dsum + (size_t)w0 * H;
    for (int i = threadIdx.x; i < pieces; i += THREADS)
      copy8_async(win + i, src + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                            // window staged
    for (const int jw = min(j1, w0 + WROWS); j < jw; ++j) {
      const float2* row = win + (j - w0) * H;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float2 v = row[h];
        acc[2 * h] += v.x;
        acc[2 * h + 1] += v.y;
      }
    }
    __syncthreads();                            // window consumed
  }

  if (g < n) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      win[threadIdx.x * H + h] = make_float2(acc[2 * h], acc[2 * h + 1]);
  }
  __syncthreads();
  float2* dst = out + (size_t)g0 * H;
  for (int i = threadIdx.x; i < (g_end - g0) * H; i += THREADS) dst[i] = win[i];
}

}  // namespace

extern "C" int gaussian_grad_sum(const float* dsum, const int* start,
                                 const float* init, float* out, int n,
                                 void* stream) {
  if (n > 0) {
    gaussian_grad_sum_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                               (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(dsum), start,
        reinterpret_cast<const float2*>(init),
        reinterpret_cast<float2*>(out), n);
  }
  return (int)cudaGetLastError();
}
