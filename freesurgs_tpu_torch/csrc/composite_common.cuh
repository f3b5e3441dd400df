// Shared pieces of the two tile-compositing kernels (composite_fwd.cu,
// composite_bwd.cu). Layouts are described in ops/raster_cuda.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fsgs {

constexpr int BIN = 32;                 // bin tile side, pixels
constexpr int NPIX = BIN * BIN;         // pixels per tile
constexpr int NTHREADS = 256;           // one CTA per tile
constexpr int NWARPS = NTHREADS / 32;
constexpr int PPT = NPIX / NTHREADS;    // pixels per thread (4)
constexpr int CHUNK = 128;              // records staged per step
constexpr int NF = 10;                  // live fields per record
constexpr int N_OUT = 8;                // output channels

constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

// Thread -> pixel map: warp w owns rows w, w+8, w+16, w+24 of the tile and
// lane l owns column l, so each warp reads and writes whole 128 B rows.
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

// One chunk of records in shared memory, fields-major like feat.
struct Records {
  float f[NF][CHUNK];
  int rect[CHUNK];
};

// Cooperative, coalesced load of slots [base, base + CHUNK).
__device__ inline void load_records(Records& r, const float* __restrict__ feat,
                                    const int* __restrict__ rect, int M,
                                    int base) {
  for (int i = threadIdx.x; i < NF * CHUNK; i += NTHREADS) {
    const int f = i / CHUNK, j = i % CHUNK;
    r.f[f][j] = feat[(size_t)f * M + base + j];
  }
  for (int j = threadIdx.x; j < CHUNK; j += NTHREADS) r.rect[j] = rect[base + j];
}

__device__ inline bool rect_in_x(const Records& r, int j, int x16) {
  const int rc = r.rect[j];
  return x16 >= (rc & 0xFF) && x16 < ((rc >> 16) & 0xFF);
}

// Alpha of record j at one pixel, with the CUDA cutoffs (power <= 0,
// alpha >= 1/255) and the packed 16 px rect mask. Returns false when the
// record does not composite there. NaN inputs fail every test, as in the
// JAX kernel.
// The caller has already passed rect_in_x for this record.
__device__ inline bool record_alpha(const Records& r, int j, float dx, float dy,
                                    int y16, float& alpha, float& raw,
                                    float& expp) {
  const int rc = r.rect[j];
  if (y16 < ((rc >> 8) & 0xFF) || y16 >= ((rc >> 24) & 0xFF)) return false;
  const float ca = r.f[2][j], cb = r.f[3][j], cc = r.f[4][j];
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  if (!(power <= 0.0f)) return false;
  expp = expf(power);
  raw = r.f[5][j] * expp;
  if (!(raw >= ALPHA_MIN)) return false;   // == min(0.99, raw) >= 1/255
  alpha = fminf(raw, ALPHA_MAX);
  return true;
}

}  // namespace fsgs
