// Tile-compositing forward kernel for Hopper (sm_90a).
//
// Replaces freesurgs_tpu/ops/raster_pallas.py:_fwd_kernel (launched by
// _run_fwd). Same function: each 32x32 bin tile composites its depth-ordered
// instance run front to back with the CUDA cutoffs (alpha = min(0.99,
// o exp(power)), skip power > 0 or alpha < 1/255, 16 px rect mask) and stops
// a pixel before the Gaussian that would push T below 1e-4. Transmittance is
// carried in log space (logT += log1p(-alpha), T = exp(logT)) as in
// ops/oracle.py, so stop decisions equal the JAX package's and the plain
// version's up to summation order.
//
// What bounds it on an H100: the f32 operations of the instance x pixel
// pairs that need float work, against 67 TFLOP/s of non-tensor f32 (a
// blended pair ~34 with three transcendentals, a pair cut by the alpha
// cutoffs ~14; pairs outside the 16 px rect or past the pixel's stop need
// none); the bytes (feat read once, the (8, Hp, Wp) output written once)
// are far smaller at 3.35 TB/s. chip_smoke.py counts both from the data.
// The design keeps every pixel's state in registers (4 pixels a thread),
// stages 128 records a step in shared memory with coalesced fields-major
// loads (each record is read from shared memory once per thread and reused
// for its 4 pixels), rejects a record with one integer test on the rect
// column before any float work, and ends the tile's walk with a block vote
// once every pixel has stopped. The
// TPU kernel's MXU cumsums and bf16 splits have no place here: each thread
// blends its pixels sequentially. Tensor cores, TMA and clusters are later
// work.

#include "composite_common.cuh"

using namespace fsgs;

__global__ void __launch_bounds__(NTHREADS)
composite_fwd_kernel(const float* __restrict__ feat, const int* __restrict__ rect,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     float* __restrict__ out, int* __restrict__ keff_out, int M,
                     int grid_x, int num_tiles) {
  __shared__ Records rec;
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  const PixelSet ps = pixel_set(tile, grid_x);
  const size_t plane = (size_t)num_tiles * NPIX;   // Hp * Wp

  float logT[PPT], acc[PPT][6];
  bool done[PPT];
  int stop[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    logT[k] = 0.0f;
    done[k] = false;
    stop[k] = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[k][c] = 0.0f;
  }

  int keff = n_chunks;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = start + c * CHUNK;
    __syncthreads();                      // previous chunk fully consumed
    load_records(rec, feat, rect, M, base);
    __syncthreads();
    const int jmax = min(CHUNK, count - c * CHUNK);
    bool mine_done = true;
#pragma unroll
    for (int k = 0; k < PPT; ++k) mine_done &= done[k];
    if (!mine_done) {
      for (int j = 0; j < jmax; ++j) {
        if (!rect_in_x(rec, j, ps.x16)) continue;
        const float dx = rec.f[0][j] - ps.fx;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (done[k]) continue;
          const float dy = rec.f[1][j] - ps.fy[k];
          float alpha, raw, expp;
          if (!record_alpha(rec, j, dx, dy, ps.y16[k], alpha, raw, expp))
            continue;
          const float T = expf(logT[k]);
          if (T * (1.0f - alpha) < T_EPS) {   // stop before this Gaussian
            done[k] = true;
            continue;
          }
          const float w = alpha * T;
          const float z = rec.f[9][j];
          acc[k][0] += w * rec.f[6][j];
          acc[k][1] += w * rec.f[7][j];
          acc[k][2] += w * rec.f[8][j];
          acc[k][3] += w * z;
          acc[k][4] += w;
          acc[k][5] += w * (z * z);
          logT[k] += log1pf(-alpha);
          stop[k] = c * CHUNK + j + 1;
        }
      }
    }
    bool all4 = true;
#pragma unroll
    for (int k = 0; k < PPT; ++k) all4 &= done[k];
    if (__syncthreads_count(all4) == NTHREADS) {  // every pixel stopped
      keff = c + 1;
      break;
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float* o = out + ps.gidx[k];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) o[ch * plane] = acc[k][ch];
    o[6 * plane] = expf(logT[k]);
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
