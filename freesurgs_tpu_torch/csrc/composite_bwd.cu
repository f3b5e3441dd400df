// Tile-compositing backward kernel for Hopper (sm_90a).
//
// Replaces freesurgs_tpu/ops/raster_pallas.py:_bwd_kernel (launched by
// _run_bwd; the per-Gaussian sum of _composite_bwd stays outside, in
// ops/raster_cuda.py). Same function: each 32x32 bin tile replays its
// forward front to back over the chunks the forward composited (< keff)
// and, from the saved totals, writes every instance's gradient with
// respect to its 10 record fields: mean2d.xy, conic (a, b, c), opacity,
// r, g, b and z (the z channel plus 2z times the z^2 channel). Chunks past
// keff are written as zeros: the output buffer is not initialised.
//
// Per pixel, with cg = sum_ch g_ch c_ch of the instance and S the running
// sum of w cg over the instances composited so far (itself included):
//   dalpha = cg T - (t0 - S + g_T T_final) / (1 - alpha),
// t0 = sum_ch g_ch out_ch being the total of all of them (suffix from the
// saved totals, no back-to-front pass). Then the chain to the fields
// through power and opacity; d(opacity) is sum dalpha exp(power)
// [raw < 0.99], computed directly.
//
// What bounds it on an H100: like the forward, the f32 operations of the
// pairs that need float work (a blended pair ~78 in this replay and chain,
// a cut pair ~14), against 67 TFLOP/s of non-tensor f32; the bytes (feat,
// out and gout read once, dfeat written once) are small beside them. The
// design: pixel carries in registers (4 pixels a thread), 128 records a
// step in shared memory, and each instance's 10 gradients reduced over
// the tile's pixels in a fixed order — a warp shuffle butterfly (skipped
// when no lane of the warp has a contribution), then a fixed-order sum over
// the 8 warps in shared memory. Slots are disjoint per tile, so there are
// no atomics and the result is deterministic.

#include "composite_common.cuh"

using namespace fsgs;

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(NTHREADS)
composite_bwd_kernel(const float* __restrict__ feat, const int* __restrict__ rect,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     const int* __restrict__ keff_in, const float* __restrict__ out,
                     const float* __restrict__ gout, float* __restrict__ dfeat,
                     int M, int grid_x, int num_tiles) {
  __shared__ Records rec;
  __shared__ float part[NWARPS][NF][CHUNK];   // per-warp instance gradients
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  const int keff = keff_in[tile];
  const PixelSet ps = pixel_set(tile, grid_x);
  const size_t plane = (size_t)num_tiles * NPIX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float g[PPT][6], gT[PPT], Tfin[PPT], t0[PPT], logT[PPT], S[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = ps.gidx[k];
    t0[k] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
      g[k][ch] = gout[ch * plane + p];
      t0[k] += g[k][ch] * out[ch * plane + p];
    }
    gT[k] = gout[6 * plane + p];
    Tfin[k] = out[6 * plane + p];
    logT[k] = 0.0f;
    S[k] = 0.0f;
    done[k] = false;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int base = start + c * CHUNK;
    if (c >= keff) {   // never composited: exact zeros, but must be written
      for (int i = threadIdx.x; i < NF * CHUNK; i += NTHREADS)
        dfeat[(size_t)(i / CHUNK) * M + base + i % CHUNK] = 0.0f;
      continue;
    }
    __syncthreads();                      // previous chunk's part[] consumed
    load_records(rec, feat, rect, M, base);
    __syncthreads();
    const int jmax = min(CHUNK, count - c * CHUNK);
    for (int j = 0; j < CHUNK; ++j) {
      float v[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) v[f] = 0.0f;
      bool any = false;
      if (j < jmax && rect_in_x(rec, j, ps.x16)) {
        const float mx = rec.f[0][j], my = rec.f[1][j];
        const float ca = rec.f[2][j], cb = rec.f[3][j], cc = rec.f[4][j];
        const float op = rec.f[5][j];
        const float cr = rec.f[6][j], cgr = rec.f[7][j], cbl = rec.f[8][j];
        const float z = rec.f[9][j];
        const float dx = mx - ps.fx;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (done[k]) continue;
          const float dy = my - ps.fy[k];
          float alpha, raw, expp;
          if (!record_alpha(rec, j, dx, dy, ps.y16[k], alpha, raw, expp))
            continue;
          const float T = expf(logT[k]);
          if (T * (1.0f - alpha) < T_EPS) {
            done[k] = true;
            continue;
          }
          any = true;
          const float w = alpha * T;
          const float cg = g[k][0] * cr + g[k][1] * cgr + g[k][2] * cbl +
                           g[k][3] * z + g[k][4] + g[k][5] * (z * z);
          S[k] += w * cg;
          const float dalpha =
              cg * T - ((t0[k] - S[k]) + gT[k] * Tfin[k]) / (1.0f - alpha);
          const float dclamp = raw < ALPHA_MAX ? dalpha : 0.0f;
          const float dpow = dclamp * op * expp;
          v[0] -= (ca * dx + cb * dy) * dpow;
          v[1] -= (cc * dy + cb * dx) * dpow;
          v[2] -= 0.5f * dx * dx * dpow;
          v[3] -= dx * dy * dpow;
          v[4] -= 0.5f * dy * dy * dpow;
          v[5] += dclamp * expp;
          v[6] += g[k][0] * w;
          v[7] += g[k][1] * w;
          v[8] += g[k][2] * w;
          v[9] += (g[k][3] + 2.0f * z * g[k][5]) * w;
          logT[k] += log1pf(-alpha);
        }
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int f = 0; f < NF; ++f) v[f] = warp_sum(v[f]);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) part[warp][f][j] = v[f];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NF * CHUNK; i += NTHREADS) {
      const int f = i / CHUNK, j = i % CHUNK;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += part[w][f][j];
      dfeat[(size_t)f * M + base + j] = s;
    }
  }
}

extern "C" int composite_bwd(const float* feat, const int* rect, const int* starts,
                             const int* counts, const int* keff, const float* out,
                             const float* gout, float* dfeat, int M, int grid_x,
                             int num_tiles, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
        feat, rect, starts, counts, keff, out, gout, dfeat, M, grid_x, num_tiles);
  }
  return (int)cudaGetLastError();
}
