// Ablation family of the first design of the tile-compositing forward
// kernel (composite_fwd.cu) for Hopper (sm_90a).
//
// Replaces scripts/kernel_overhead.py:make_fwd, the TPU's structural copies
// of its forward kernel with one mechanism removed each, timed side by side
// to attribute the kernel's time. The TPU variants remove TPU mechanisms
// (the DMA double buffer, the carry's lane reductions, the keff watermark);
// these remove the first design's own, one template switch each:
//
//   STOP    the per-pixel T < 1e-4 stop test, the skip of stopped pixels
//           and the block vote that ends the walk (off: every slot of the
//           run composites, keff = the run's chunks)
//   RECT    the integer 16 px rect tests (off: the rect mask passes all)
//   SHARED  staging 128 records a step in shared memory, with its two
//           __syncthreads per chunk (off: each thread reads the records
//           from global memory through the read-only path)
//   LOGT    log-space transmittance, T = exp(logT), logT += log1p(-alpha)
//           (off: T *= 1 - alpha)
//
// With every switch on the code is the first design of composite_fwd.cu,
// expression for expression: its thread -> pixel map and its cooperative
// loads are kept below, so "baseline" times that design beside the
// forward of today, and "noshared", whose function is the same, must
// equal "baseline" bit for bit; ops/raster_ablate.py holds each
// variant to its plain version. What bounds each variant is what bounds
// the forward: the f32 operations of the pairs that variant's function
// needs (chip_smoke.py counts them from the data); the bytes are the
// forward's. The family is a measuring tool, written as simply as the
// forward was.

#include "composite_common.cuh"

using namespace fsgs;

namespace {

// The first design's thread -> pixel map: warp w owns rows w, w+8, w+16,
// w+24 of the tile and lane l owns column l, so each warp reads and writes
// whole 128 B rows (and spans both 16 px columns).
struct PixelSet {
  float fx;            // pixel x (image coords)
  int x16;             // its 16 px tile column
  float fy[PPT];
  int y16[PPT];
  int gidx[PPT];       // offset of the pixel in one (Hp, Wp) plane
};

__device__ inline PixelSet pixel_set(int tile, int grid_x) {
  PixelSet ps;
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

// The first design's staging: a cooperative, coalesced load of slots
// [base, base + CHUNK) by all threads.
__device__ inline void load_records(Records& r, const float* __restrict__ feat,
                                    const int* __restrict__ rect, int M,
                                    int base) {
  for (int i = threadIdx.x; i < NF * CHUNK; i += NTHREADS) {
    const int f = i / CHUNK, j = i % CHUNK;
    r.f[f][j] = feat[(size_t)f * M + base + j];
  }
  for (int j = threadIdx.x; j < CHUNK; j += NTHREADS) r.rect[j] = rect[base + j];
}

// Where a chunk's records are read: shared memory after a staged load, or
// global memory directly.
template <bool SHARED>
struct Src;

template <>
struct Src<true> {
  const Records& r;
  __device__ float f(int k, int j) const { return r.f[k][j]; }
  __device__ int rect(int j) const { return r.rect[j]; }
};

template <>
struct Src<false> {
  const float* feat;   // read through __ldg
  const int* rects;
  int M;
  int base;
  __device__ float f(int k, int j) const {
    return __ldg(feat + (size_t)k * M + base + j);
  }
  __device__ int rect(int j) const { return __ldg(rects + base + j); }
};

template <bool RECT, class S>
__device__ inline bool in_x(const S& s, int j, int x16) {
  if constexpr (!RECT) return true;
  const int rc = s.rect(j);
  return x16 >= (rc & 0xFF) && x16 < ((rc >> 16) & 0xFF);
}

// The first design's alpha of one pair, with the y rect test switchable.
template <bool RECT, class S>
__device__ inline bool alpha_of(const S& s, int j, float dx, float dy, int y16,
                                float& alpha) {
  if constexpr (RECT) {
    const int rc = s.rect(j);
    if (y16 < ((rc >> 8) & 0xFF) || y16 >= ((rc >> 24) & 0xFF)) return false;
  }
  const float ca = s.f(2, j), cb = s.f(3, j), cc = s.f(4, j);
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  if (!(power <= 0.0f)) return false;
  const float expp = expf(power);
  const float raw = s.f(5, j) * expp;
  if (!(raw >= ALPHA_MIN)) return false;
  alpha = fminf(raw, ALPHA_MAX);
  return true;
}

// One chunk of the walk over records [0, jmax) of s.
template <bool STOP, bool RECT, bool LOGT, class S>
__device__ inline void walk(const S& s, int jmax, int c, const PixelSet& ps,
                            float (&tr)[PPT], float (&acc)[PPT][6],
                            bool (&done)[PPT], int (&stop)[PPT]) {
  for (int j = 0; j < jmax; ++j) {
    if (!in_x<RECT>(s, j, ps.x16)) continue;
    const float dx = s.f(0, j) - ps.fx;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (STOP && done[k]) continue;
      const float dy = s.f(1, j) - ps.fy[k];
      float alpha;
      if (!alpha_of<RECT>(s, j, dx, dy, ps.y16[k], alpha)) continue;
      const float T = LOGT ? expf(tr[k]) : tr[k];
      if (STOP && T * (1.0f - alpha) < T_EPS) {   // stop before this one
        done[k] = true;
        continue;
      }
      const float w = alpha * T;
      const float z = s.f(9, j);
      acc[k][0] += w * s.f(6, j);
      acc[k][1] += w * s.f(7, j);
      acc[k][2] += w * s.f(8, j);
      acc[k][3] += w * z;
      acc[k][4] += w;
      acc[k][5] += w * (z * z);
      if constexpr (LOGT) {
        tr[k] += log1pf(-alpha);
      } else {
        tr[k] *= 1.0f - alpha;
      }
      stop[k] = c * CHUNK + j + 1;
    }
  }
}

template <bool STOP, bool RECT, bool SHARED, bool LOGT>
__global__ void __launch_bounds__(NTHREADS)
ablate_kernel(const float* __restrict__ feat, const int* __restrict__ rect,
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

  // tr: logT with LOGT, else T itself
  float tr[PPT], acc[PPT][6];
  bool done[PPT];
  int stop[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    tr[k] = LOGT ? 0.0f : 1.0f;
    done[k] = false;
    stop[k] = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[k][c] = 0.0f;
  }

  int keff = n_chunks;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = start + c * CHUNK;
    if constexpr (SHARED) {
      __syncthreads();                    // previous chunk fully consumed
      load_records(rec, feat, rect, M, base);
      __syncthreads();
    }
    const int jmax = min(CHUNK, count - c * CHUNK);
    bool mine_done = STOP;
#pragma unroll
    for (int k = 0; k < PPT; ++k) mine_done &= done[k];
    if (!mine_done) {
      if constexpr (SHARED) {
        walk<STOP, RECT, LOGT>(Src<true>{rec}, jmax, c, ps, tr, acc, done,
                               stop);
      } else {
        walk<STOP, RECT, LOGT>(Src<false>{feat, rect, M, base}, jmax, c, ps,
                               tr, acc, done, stop);
      }
    }
    if constexpr (STOP) {
      bool all4 = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) all4 &= done[k];
      if (__syncthreads_count(all4) == NTHREADS) {  // every pixel stopped
        keff = c + 1;
        break;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float* o = out + ps.gidx[k];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) o[ch * plane] = acc[k][ch];
    o[6 * plane] = LOGT ? expf(tr[k]) : tr[k];
    o[7 * plane] = (float)stop[k];
  }
  if (threadIdx.x == 0) keff_out[tile] = keff;
}

template <bool STOP, bool RECT, bool SHARED, bool LOGT>
int launch(const float* feat, const int* rect, const int* starts,
           const int* counts, float* out, int* keff, int M, int grid_x,
           int num_tiles, void* stream) {
  if (num_tiles > 0) {
    ablate_kernel<STOP, RECT, SHARED, LOGT>
        <<<num_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
            feat, rect, starts, counts, out, keff, M, grid_x, num_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define FSGS_ABLATE_ENTRY(NAME, STOP, RECT, SHARED, LOGT)                      \
  extern "C" int composite_fwd_ablate_##NAME(                                  \
      const float* feat, const int* rect, const int* starts,                   \
      const int* counts, float* out, int* keff, int M, int grid_x,             \
      int num_tiles, void* stream) {                                           \
    return launch<STOP, RECT, SHARED, LOGT>(feat, rect, starts, counts, out,   \
                                            keff, M, grid_x, num_tiles,        \
                                            stream);                           \
  }

//                  variant   STOP   RECT   SHARED LOGT
FSGS_ABLATE_ENTRY(baseline, true, true, true, true)
FSGS_ABLATE_ENTRY(nostop, false, true, true, true)
FSGS_ABLATE_ENTRY(norect, true, false, true, true)
FSGS_ABLATE_ENTRY(noshared, true, true, false, true)
FSGS_ABLATE_ENTRY(linear_t, true, true, true, false)
FSGS_ABLATE_ENTRY(minimal, false, false, false, false)
