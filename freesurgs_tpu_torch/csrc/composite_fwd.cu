// Tile-compositing forward kernel for Hopper (sm_90a).
//
// Replaces freesurgs_tpu/ops/raster_pallas.py:_fwd_kernel (launched by
// _run_fwd). Same function: each 32x32 bin tile composites its depth-ordered
// instance run front to back with the CUDA cutoffs (alpha = min(0.99,
// o exp(power)), skip power > 0 or alpha < 1/255, 16 px rect mask) and stops
// a pixel before the Gaussian that would push T below 1e-4. Transmittance is
// carried in log space (logT += log1p(-alpha), T = exp(logT)) as in
// ops/oracle.py, so stop decisions equal the JAX package's and the plain
// version's up to summation order. Output channel 7 is each pixel's stop
// index (its last composited slot + 1), which the backward replays from.
//
// What bounds it on an H100: the f32 operations of the instance x pixel
// pairs that need float work, against 67 TFLOP/s of non-tensor f32 (a
// blended pair ~34 with three transcendentals, a pair cut by the alpha
// cutoffs ~14; pairs outside the 16 px rect or past the pixel's stop need
// none); the bytes (feat read once, the (8, Hp, Wp) output written once)
// are far smaller at 3.35 TB/s. chip_smoke.py counts both from the data.
// What held the first design to ~6% of that bound, by its ablation
// (K3, ops/raster_ablate.py): ~65% of its time was the walk over the staged
// records, where the 16 px rect test diverged inside every warp (each warp
// spanned all four quadrants, so the test cost more than it saved), 20%
// log-space T and 11% the stop machinery; and each chunk's load waited for
// the walk of the one before. So:
//  - every warp owns one 16x16 quadrant (composite_common.cuh), and a
//    record whose 16 px rect misses it costs one uniform branch;
//  - chunks of 128 records arrive by bulk copy (TMA) into two shared-memory
//    buffers on mbarriers; chunk c + 1 lands while chunk c is walked, and
//    one __syncthreads per chunk both releases a buffer and votes on the
//    early stop;
//  - a stopped pixel's logT becomes -inf, so T = exp(logT) = 0 fails the
//    stop test and skips it with no flag tested per pair; a warp whose 128
//    pixels all stopped skips the walk.
// Log-space T stays: it is the contract of the stop decisions. ptxas: 64
// registers, 11 KB of shared memory, so 4 CTAs (32 warps) fit an SM.

#include <math_constants.h>

#include "composite_common.cuh"

using namespace fsgs;

#define NEG_INF (-CUDART_INF_F)   // the logT of a stopped pixel

__global__ void __launch_bounds__(NTHREADS, 3)
composite_fwd_kernel(const float* __restrict__ feat, const int* __restrict__ rect,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     float* __restrict__ out, int* __restrict__ keff_out, int M,
                     int grid_x, int num_tiles) {
  __shared__ Stage st;
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  const QuadPixels px = quad_pixels(tile, grid_x);
  const size_t plane = (size_t)num_tiles * NPIX;   // Hp * Wp

  if (threadIdx.x == 0) {
    stage_init(st);
    if (n_chunks > 0) stage_issue(st, 0, feat, rect, M, start);
    if (n_chunks > 1) stage_issue(st, 1, feat, rect, M, start + CHUNK);
  }
  __syncthreads();                        // barriers initialised

  // logT = -inf marks a stopped pixel; Tstop keeps its T at the stop
  float logT[PPT], Tstop[PPT], acc[PPT][6];
  int stop[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    logT[k] = 0.0f;
    Tstop[k] = 0.0f;
    stop[k] = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[k][c] = 0.0f;
  }

  int keff = n_chunks;
  bool warp_done = false;
  for (int c = 0; c < n_chunks; ++c) {
    if (!warp_done) {
      stage_wait(st, c);
      const Records& r = st.buf[c & 1];
      const int jmax = min(CHUNK, count - c * CHUNK);
      for (int j = 0; j < jmax; ++j) {
        if (!rect_hits(r.rect[j], px.x16, px.y16)) continue;   // uniform
        const float dx = r.f[0][j] - px.fx;
        const float my = r.f[1][j];
        const float dxx_a = __fmul_rn(__fmul_rn(r.f[2][j], dx), dx);
        const float dx_b = __fmul_rn(r.f[3][j], dx);
        const float cc = r.f[4][j], op = r.f[5][j];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float dy = my - pixel_y(px, k);
          float alpha, raw, expp;
          if (!pair_alpha(dxx_a, dx_b, dy, cc, op, alpha, raw, expp)) continue;
          const float T = expf(logT[k]);
          if (T * (1.0f - alpha) < T_EPS) {   // stop before this Gaussian
            if (T > 0.0f) Tstop[k] = T;       // (0 once stopped)
            logT[k] = NEG_INF;
            continue;
          }
          const float w = alpha * T;
          const float z = r.f[9][j];
          acc[k][0] += w * r.f[6][j];
          acc[k][1] += w * r.f[7][j];
          acc[k][2] += w * r.f[8][j];
          acc[k][3] += w * z;
          acc[k][4] += w;
          acc[k][5] += w * (z * z);
          logT[k] += log1pf(-alpha);
          stop[k] = c * CHUNK + j + 1;
        }
      }
      bool all4 = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) all4 &= (logT[k] == NEG_INF);
      warp_done = __all_sync(FULL_MASK, all4);
    }
    // chunk c's buffer is released; stop once every pixel has stopped
    if (__syncthreads_and(warp_done)) {
      keff = c + 1;
      if (threadIdx.x == 0 && c + 1 < n_chunks) stage_wait(st, c + 1);
      break;                              // (no copy left in flight)
    }
    if (threadIdx.x == 0 && c + 2 < n_chunks)
      stage_issue(st, c & 1, feat, rect, M, start + (c + 2) * CHUNK);
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float* o = out + px.gidx0 + k * px.row_stride;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) o[ch * plane] = acc[k][ch];
    o[6 * plane] = logT[k] == NEG_INF ? Tstop[k] : expf(logT[k]);
    o[7 * plane] = (float)stop[k];
  }
  if (threadIdx.x == 0) keff_out[tile] = keff;
}

extern "C" int composite_fwd(const float* feat, const int* rect, const int* starts,
                             const int* counts, float* out, int* keff, int M,
                             int grid_x, int num_tiles, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
        feat, rect, starts, counts, out, keff, M, grid_x, num_tiles);
  }
  return (int)cudaGetLastError();
}
