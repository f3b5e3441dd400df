// Per-Gaussian gradient sum as a difference of prefix sums, the JAX
// package's default backward reduction (sm_90a).
//
// Replaces the fast_binning=True branch of _composite_bwd in
// freesurgs_tpu/ops/raster_pallas.py (:737-756): the instance gradients,
// gathered into pre-slot order (the depth-major expansion: Gaussians front
// to back, each Gaussian's tiles row-major), take one f32 jnp.cumsum over
// all M rows, and Gaussian g's sum is csum[seg_hi[g]] - csum[seg_lo[g]]
// of the zero-prefixed scan (freesurgs_tpu/ops/binning_fast.py BinAux).
//
// Inputs: pre (M, 10), K2's rows (composite_bwd.cu) stored at each slot's
// pre-slot index (ops/binning.py pre_rank; padding slots' rows are +0);
// seg_lo / seg_hi (n,) int32, each Gaussian's run of pre-slots; scratch,
// 10 floats for every row of the upper levels (ops/raster_cuda.py
// scan_levels). Output: out (n, 10).
//
// The association order is the one jnp.cumsum takes on XLA's CPU backend
// (its reduce-window rewrite with base length 16), so that the result is
// the JAX package's bit for bit on the same rows:
//   S(x)[i] = W[i] + E[i / 16]  where the level has more than 16 rows,
//   S(x)[i] = W[i]              where it has at most 16 (the top),
// with W[i] the block of 16's own rows up to i added one at a time from +0,
// T the blocks' totals (every block's 16 rows, zero-padded past the end,
// added the same way), and E[b] = b > 0 ? S(T)[b - 1] : +0 (one f32 add).
// For M = 824,341 rows the levels hold 51,522, 3,221, 202 and 13 rows.
//
// Launches on one stream: the totals of each level from the one below
// (thread per block and field), the scans of the upper levels from the top
// down, each in place over its totals (same threads), then one lookup per
// Gaussian and field, which forms the two level-0 values it needs from at
// most 16 rows each and one row of level 1's scan: level 0's scan is never
// stored. Every add is a plain f32 add in a fixed order: deterministic, no
// atomics, equal to ops/raster_cuda.py gaussian_grad_prefix_plain.
//
// What bounds it on an H100: the bytes (pre read once, 40 B a row; seg_lo
// / seg_hi read and out written once) against 3.35 TB/s. The lookup reads
// up to 2 x 16 rows a Gaussian, from L2 where neighbouring runs share
// blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 10;
constexpr int BASE = 16;
constexpr int THREADS = 256;

// t[b] = rows 16b .. 16b + 15 of x, added in order from +0 (zeros past L)
__global__ void __launch_bounds__(THREADS)
block_totals_kernel(const float* __restrict__ x, int L,
                    float* __restrict__ t, int nb) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= nb * NF) return;
  const int b = idx / NF, f = idx % NF;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < BASE; ++j) {
    const int r = b * BASE + j;
    acc += r < L ? x[(size_t)r * NF + f] : 0.0f;
  }
  t[idx] = acc;
}

// x <- S(x) in place, given upper = S(T) of its totals (null at the top)
__global__ void __launch_bounds__(THREADS)
block_scan_kernel(float* __restrict__ x, int L,
                  const float* __restrict__ upper, int nb) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= nb * NF) return;
  const int b = idx / NF, f = idx % NF;
  const float e = upper != nullptr && b > 0 ? upper[(b - 1) * NF + f] : 0.0f;
  float acc = 0.0f;
  for (int j = 0; j < BASE; ++j) {
    const int r = b * BASE + j;
    if (r >= L) break;
    acc += x[(size_t)r * NF + f];
    x[(size_t)r * NF + f] = upper != nullptr ? acc + e : acc;
  }
}

// the zero-prefixed scan of level 0 at k: S(x)[k - 1], or +0 at k = 0
__device__ inline float csum_at(const float* __restrict__ x,
                                const float* __restrict__ s1, int k, int f) {
  if (k == 0) return 0.0f;
  const int i = k - 1;
  const int b = i / BASE;
  float acc = 0.0f;
  for (int r = b * BASE; r <= i; ++r) acc += x[(size_t)r * NF + f];
  if (s1 == nullptr) return acc;
  return acc + (b > 0 ? s1[(b - 1) * NF + f] : 0.0f);
}

__global__ void __launch_bounds__(THREADS)
prefix_lookup_kernel(const float* __restrict__ x,
                     const float* __restrict__ s1,
                     const int* __restrict__ seg_lo,
                     const int* __restrict__ seg_hi, float* __restrict__ out,
                     int n) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n * NF) return;
  const int g = idx / NF, f = idx % NF;
  out[idx] = csum_at(x, s1, seg_hi[g], f) - csum_at(x, s1, seg_lo[g], f);
}

inline int blocks_for(int items) { return (items + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int gaussian_grad_prefix(const float* pre, const int* seg_lo,
                                    const int* seg_hi, float* scratch,
                                    float* out, int m, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the upper levels: lengths and their places in scratch
  int len[32], nlev = 0;
  float* lev[32];
  size_t off = 0;
  for (int L = m; L > BASE; ++nlev) {
    L = (L + BASE - 1) / BASE;
    len[nlev] = L;
    lev[nlev] = scratch + off;
    off += (size_t)L * NF;
  }
  // totals, bottom up
  const float* below = pre;
  int L_below = m;
  for (int l = 0; l < nlev; ++l) {
    block_totals_kernel<<<blocks_for(len[l] * NF), THREADS, 0, st>>>(
        below, L_below, lev[l], len[l]);
    below = lev[l];
    L_below = len[l];
  }
  // scans in place, top down: the top one alone, each other one plus the
  // scan above it
  for (int l = nlev - 1; l >= 0; --l) {
    const int nb = (len[l] + BASE - 1) / BASE;
    block_scan_kernel<<<blocks_for(nb * NF), THREADS, 0, st>>>(
        lev[l], len[l], l + 1 < nlev ? lev[l + 1] : nullptr, nb);
  }
  if (n > 0) {
    prefix_lookup_kernel<<<blocks_for(n * NF), THREADS, 0, st>>>(
        pre, nlev > 0 ? lev[0] : nullptr, seg_lo, seg_hi, out, n);
  }
  return (int)cudaGetLastError();
}
