// Ablation family of the tile-compositing forward kernel (composite_fwd.cu,
// K1) for Hopper (sm_90a).
//
// Replaces scripts/kernel_overhead.py:make_fwd, the TPU's structural copies
// of its forward kernel with one mechanism removed each, timed side by side
// to attribute the kernel's time. The TPU variants remove TPU mechanisms
// (the DMA double buffer, the carry's lane reductions, the keff watermark);
// these remove K1's own Hopper mechanisms, one template switch each:
//
//   STOP  the T < 1e-4 stop, the -inf logT of a stopped pixel, the
//         __syncthreads_and vote that ends the walk and the skip of a warp
//         whose pixels all stopped (off: every slot of the run composites,
//         keff = the run's chunks)
//   RECT  the warp-uniform 16 px rect branch (off: the rect mask passes
//         all, so every warp walks every record)
//   BULK  the double-buffered bulk copies (TMA) on mbarriers (off: one
//         cooperative synchronous load per chunk into one buffer, two
//         __syncthreads a chunk)
//   QUAD  the quadrant pixel map (off: the first design's rows, warp w
//         owning rows w, w + 8, w + 16, w + 24 and lane l column l, so the
//         16 px rect test splits every warp: its x half per lane, its y
//         half per pixel)
//   LOGT  log-space transmittance, T = exp(logT), logT += log1p(-alpha)
//         (off: T *= 1 - alpha)
//
// With every switch on the code is K1's, expression for expression, and
// must give K1's output and keff bit for bit; BULK and QUAD change where
// records and pixels live, not the arithmetic of any pair, so "nobulk" and
// "rowmap" must equal "baseline" bit for bit too. ops/raster_ablate.py
// holds each variant to its plain version. What bounds each variant is
// what bounds K1: the f32 operations of the pairs that variant's function
// needs (chip_smoke.py counts them from the data); its bytes are K1's.
// Each variant's time beside baseline's attributes K1's time to its
// mechanisms. The family is a measuring tool; it follows K1 rather than
// being tuned itself.

#include <math_constants.h>

#include "composite_common.cuh"

using namespace fsgs;

namespace {

// The first design's thread -> pixel map (QUAD off).
struct RowPixels {
  float fx;            // pixel x (image coords)
  int x16;             // its 16 px tile column
  float fy[PPT];
  int y16[PPT];
  int gidx[PPT];       // offset of the pixel in one (Hp, Wp) plane
};

__device__ inline RowPixels row_pixels(int tile, int grid_x) {
  RowPixels ps;
  const int lane = threadIdx.x % 32;
  const int row0 = threadIdx.x / 32;
  const int x = (tile % grid_x) * BIN + lane;
  const int wp = grid_x * BIN;
  ps.fx = (float)x;
  ps.x16 = x >> 4;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int y = (tile / grid_x) * BIN + row0 + NWARPS * k;
    ps.fy[k] = (float)y;
    ps.y16[k] = y >> 4;
    ps.gidx[k] = y * wp + x;
  }
  return ps;
}

// Pixel k of the thread, in either map: its row and its offset in a plane.
template <bool QUAD>
struct Pixels;

template <>
struct Pixels<true> {
  QuadPixels p;
  __device__ Pixels(int tile, int grid_x) : p(quad_pixels(tile, grid_x)) {}
  __device__ float fx() const { return p.fx; }
  __device__ float fy(int k) const { return pixel_y(p, k); }
  __device__ int gidx(int k) const { return p.gidx0 + k * p.row_stride; }
};

template <>
struct Pixels<false> {
  RowPixels p;
  __device__ Pixels(int tile, int grid_x) : p(row_pixels(tile, grid_x)) {}
  __device__ float fx() const { return p.fx; }
  __device__ float fy(int k) const { return p.fy[k]; }
  __device__ int gidx(int k) const { return p.gidx[k]; }
};

// BULK off: all threads load records [base, base + CHUNK) into r.
__device__ inline void load_records(Records& r, const float* __restrict__ feat,
                                    const int* __restrict__ rect, int M,
                                    int base) {
  for (int i = threadIdx.x; i < NF * CHUNK; i += NTHREADS) {
    const int f = i / CHUNK, j = i % CHUNK;
    r.f[f][j] = feat[(size_t)f * M + base + j];
  }
  for (int j = threadIdx.x; j < CHUNK; j += NTHREADS) r.rect[j] = rect[base + j];
}

// The per-pixel state: tr is logT with LOGT (-inf once stopped), else T
// itself (0 once stopped); Tstop the T at the stop.
struct PixState {
  float tr[PPT], Tstop[PPT], acc[PPT][6];
  int stop[PPT];
};

template <bool LOGT>
__device__ inline float stopped_tr() {
  return LOGT ? -CUDART_INF_F : 0.0f;
}

// One chunk of K1's walk over records [0, jmax) of r.
template <bool STOP, bool RECT, bool QUAD, bool LOGT>
__device__ __forceinline__ void walk(const Records& r, int jmax, int c,
                            const Pixels<QUAD>& px, PixState& s) {
  for (int j = 0; j < jmax; ++j) {
    int rc = 0;
    if constexpr (RECT) {
      rc = r.rect[j];
      if constexpr (QUAD) {
        if (!rect_hits(rc, px.p.x16, px.p.y16)) continue;   // uniform
      } else {
        if (px.p.x16 < (rc & 0xFF) || px.p.x16 >= ((rc >> 16) & 0xFF))
          continue;                                          // per lane
      }
    }
    const float dx = r.f[0][j] - px.fx();
    const float my = r.f[1][j];
    const float dxx_a = __fmul_rn(__fmul_rn(r.f[2][j], dx), dx);
    const float dx_b = __fmul_rn(r.f[3][j], dx);
    const float cc = r.f[4][j], op = r.f[5][j];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if constexpr (RECT && !QUAD) {                         // per pixel
        if (px.p.y16[k] < ((rc >> 8) & 0xFF) ||
            px.p.y16[k] >= ((rc >> 24) & 0xFF))
          continue;
      }
      const float dy = my - px.fy(k);
      float alpha, raw, expp;
      if (!pair_alpha(dxx_a, dx_b, dy, cc, op, alpha, raw, expp)) continue;
      const float T = LOGT ? expf(s.tr[k]) : s.tr[k];
      if (STOP && T * (1.0f - alpha) < T_EPS) {   // stop before this Gaussian
        if (T > 0.0f) s.Tstop[k] = T;            // (0 once stopped)
        s.tr[k] = stopped_tr<LOGT>();
        continue;
      }
      const float w = alpha * T;
      const float z = r.f[9][j];
      s.acc[k][0] += w * r.f[6][j];
      s.acc[k][1] += w * r.f[7][j];
      s.acc[k][2] += w * r.f[8][j];
      s.acc[k][3] += w * z;
      s.acc[k][4] += w;
      s.acc[k][5] += w * (z * z);
      if constexpr (LOGT) {
        s.tr[k] += log1pf(-alpha);
      } else {
        s.tr[k] *= 1.0f - alpha;
      }
      s.stop[k] = c * CHUNK + j + 1;
    }
  }
}

// Have all the warp's pixels stopped?
template <bool LOGT>
__device__ __forceinline__ bool warp_stopped(const PixState& s) {
  bool all4 = true;
#pragma unroll
  for (int k = 0; k < PPT; ++k) all4 &= (s.tr[k] == stopped_tr<LOGT>());
  return __all_sync(FULL_MASK, all4);
}

template <bool STOP, bool RECT, bool BULK, bool QUAD, bool LOGT>
__global__ void __launch_bounds__(NTHREADS, 3)
ablate_kernel(const float* __restrict__ feat, const int* __restrict__ rect,
              const int* __restrict__ starts, const int* __restrict__ counts,
              float* __restrict__ out, int* __restrict__ keff_out, int M,
              int grid_x, int num_tiles) {
  __shared__ Stage st;                    // BULK off: buf[0] only
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  const Pixels<QUAD> px(tile, grid_x);
  const size_t plane = (size_t)num_tiles * NPIX;   // Hp * Wp

  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      stage_init(st);
      if (n_chunks > 0) stage_issue(st, 0, feat, rect, M, start);
      if (n_chunks > 1) stage_issue(st, 1, feat, rect, M, start + CHUNK);
    }
    __syncthreads();                      // barriers initialised
  }

  PixState s;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    s.tr[k] = LOGT ? 0.0f : 1.0f;
    s.Tstop[k] = 0.0f;
    s.stop[k] = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c) s.acc[k][c] = 0.0f;
  }

  int keff = n_chunks;
  bool warp_done = false;
  for (int c = 0; c < n_chunks; ++c) {
    if constexpr (!BULK) {
      load_records(st.buf[0], feat, rect, M, start + c * CHUNK);
      __syncthreads();                    // chunk c staged
    }
    if (!warp_done) {
      if constexpr (BULK) stage_wait(st, c);
      const int jmax = min(CHUNK, count - c * CHUNK);
      walk<STOP, RECT, QUAD, LOGT>(st.buf[BULK ? c & 1 : 0], jmax, c, px, s);
      if constexpr (STOP) warp_done = warp_stopped<LOGT>(s);
    }
    // chunk c's buffer is released; with STOP, stop once every pixel has
    if constexpr (STOP) {
      if (__syncthreads_and(warp_done)) {
        keff = c + 1;
        if (BULK && threadIdx.x == 0 && c + 1 < n_chunks) stage_wait(st, c + 1);
        break;                            // (no copy left in flight)
      }
    } else {
      __syncthreads();
    }
    if (BULK && threadIdx.x == 0 && c + 2 < n_chunks)
      stage_issue(st, c & 1, feat, rect, M, start + (c + 2) * CHUNK);
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float* o = out + px.gidx(k);
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) o[ch * plane] = s.acc[k][ch];
    const bool stopped = STOP && s.tr[k] == stopped_tr<LOGT>();
    o[6 * plane] = stopped ? s.Tstop[k] : (LOGT ? expf(s.tr[k]) : s.tr[k]);
    o[7 * plane] = (float)s.stop[k];
  }
  if (threadIdx.x == 0) keff_out[tile] = keff;
}

template <bool STOP, bool RECT, bool BULK, bool QUAD, bool LOGT>
int launch(const float* feat, const int* rect, const int* starts,
           const int* counts, float* out, int* keff, int M, int grid_x,
           int num_tiles, void* stream) {
  if (num_tiles > 0) {
    ablate_kernel<STOP, RECT, BULK, QUAD, LOGT>
        <<<num_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
            feat, rect, starts, counts, out, keff, M, grid_x, num_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define FSGS_ABLATE_ENTRY(NAME, STOP, RECT, BULK, QUAD, LOGT)                 \
  extern "C" int composite_fwd_ablate_##NAME(                                 \
      const float* feat, const int* rect, const int* starts,                  \
      const int* counts, float* out, int* keff, int M, int grid_x,            \
      int num_tiles, void* stream) {                                          \
    return launch<STOP, RECT, BULK, QUAD, LOGT>(                              \
        feat, rect, starts, counts, out, keff, M, grid_x, num_tiles, stream); \
  }

//                variant   STOP   RECT   BULK   QUAD   LOGT
FSGS_ABLATE_ENTRY(baseline, true, true, true, true, true)
FSGS_ABLATE_ENTRY(nostop, false, true, true, true, true)
FSGS_ABLATE_ENTRY(norect, true, false, true, true, true)
FSGS_ABLATE_ENTRY(nobulk, true, true, false, true, true)
FSGS_ABLATE_ENTRY(rowmap, true, true, true, false, true)
FSGS_ABLATE_ENTRY(linear_t, true, true, true, true, false)
FSGS_ABLATE_ENTRY(minimal, false, false, false, false, false)
