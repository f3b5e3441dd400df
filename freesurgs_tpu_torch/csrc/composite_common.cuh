// Shared pieces of the two tile-compositing kernels (composite_fwd.cu,
// composite_bwd.cu): the warp-uniform pixel map, the alpha of one
// (record, pixel) pair, and the double-buffered bulk-copy staging of record
// chunks. Layouts are described in ops/raster_cuda.py.
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

constexpr unsigned FULL_MASK = 0xffffffffu;

// ------------------------------------------------------------ pixel map
//
// Each warp owns 128 pixels of ONE 16x16 quadrant of the 32x32 tile, so the
// packed 16 px rect test is the same for all its lanes: a record whose rect
// misses the quadrant is skipped by a uniform branch. Warps 2q and 2q+1
// share quadrant q (x half q & 1, y half q >> 1) and take its upper and
// lower 8 rows; lane l owns column l % 16 and rows l / 16 + 2k, k < 4.
constexpr int QUAD = 16;
constexpr int ROW_STEP = 2;             // rows between a thread's pixels

struct QuadPixels {
  int x16, y16;        // the warp's 16 px tile (warp-uniform)
  float fx;            // the thread's pixel column (image coords)
  float fy0;           // pixel k's row is fy0 + ROW_STEP * k (exact)
  int gidx0;           // offset of pixel 0 in one (Hp, Wp) plane
  int row_stride;      // ROW_STEP * Wp: offset from pixel k to k + 1
};

__device__ inline QuadPixels quad_pixels(int tile, int grid_x) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = warp >> 1;
  const int x = (tile % grid_x) * BIN + (q & 1) * QUAD + (lane % QUAD);
  const int y = (tile / grid_x) * BIN + (q >> 1) * QUAD + (warp & 1) * 8 +
                lane / QUAD;
  const int wp = grid_x * BIN;
  QuadPixels p;
  p.x16 = x >> 4;
  p.y16 = y >> 4;
  p.fx = (float)x;
  p.fy0 = (float)y;
  p.gidx0 = y * wp + x;
  p.row_stride = ROW_STEP * wp;
  return p;
}

__device__ inline float pixel_y(const QuadPixels& p, int k) {
  return p.fy0 + (float)(ROW_STEP * k);   // integers: no rounding
}

// The 16 px tile (x16, y16) lies inside the packed rect
// tx0 | ty0 << 8 | tx1 << 16 | ty1 << 24.
__device__ inline bool rect_hits(int rc, int x16, int y16) {
  return x16 >= (rc & 0xFF) && x16 < ((rc >> 16) & 0xFF) &&
         y16 >= ((rc >> 8) & 0xFF) && y16 < ((rc >> 24) & 0xFF);
}

// Alpha of one record at one pixel with the CUDA cutoffs (power <= 0,
// alpha >= 1/255); false when the pair does not composite. The power is
// rounded op by op in the plain version's order (ops/oracle.py
// gaussian_alpha), with no contraction, so the forward and the backward
// decide every cutoff identically. NaN inputs fail every test.
// dxx_a = (ca dx) dx and dx_b = cb dx are the record's per-column terms.
__device__ inline bool pair_alpha(float dxx_a, float dx_b, float dy, float cc,
                                  float op, float& alpha, float& raw,
                                  float& expp) {
  const float quad = __fadd_rn(dxx_a, __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(dx_b, dy));
  if (!(power <= 0.0f)) return false;
  expp = expf(power);
  raw = __fmul_rn(op, expp);
  if (!(raw >= ALPHA_MIN)) return false;   // == min(0.99, raw) >= 1/255
  alpha = fminf(raw, ALPHA_MAX);
  return true;
}

// ------------------------------------------------------------ staging
//
// One chunk of records in shared memory, fields-major like feat: each row
// is 512 contiguous bytes of device memory (feat[f * M + base ...], base
// and M multiples of CHUNK), so a chunk is 11 one-dimensional bulk copies
// (TMA) that complete on an mbarrier. Two buffers: chunk c + 1 (and c + 2
// once c's buffer is released) loads while chunk c is walked.
struct __align__(16) Records {
  float f[NF][CHUNK];
  int rect[CHUNK];
};
constexpr uint32_t RECORD_BYTES = sizeof(Records);   // 5632

struct __align__(16) Stage {
  Records buf[2];
  uint64_t full[2];    // mbarrier per buffer: phase k = its k-th load
};

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread, before the CTA's first __syncthreads.
__device__ inline void stage_init(Stage& s) {
  for (int b = 0; b < 2; ++b)   // one arrival (the issuing thread's) a phase
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(&s.full[b])),
                 "r"(1u)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: load records [base, base + CHUNK) into buffer b. The buffer's
// previous contents must be released (a __syncthreads after their last
// read); the proxy fence orders those reads before the async writes.
__device__ inline void stage_issue(Stage& s, int b, const float* feat,
                                   const int* rect, int M, int base) {
  const uint32_t bar = smem_addr(&s.full[b]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(RECORD_BYTES)
               : "memory");
  for (int f = 0; f <= NF; ++f) {
    const void* src = f < NF ? (const void*)(feat + (size_t)f * M + base)
                             : (const void*)(rect + base);
    void* dst = f < NF ? (void*)s.buf[b].f[f] : (void*)s.buf[b].rect;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"((uint32_t)(CHUNK * 4)), "r"(bar)
        : "memory");
  }
}

// Wait until chunk c (in buffer c & 1, its (c >> 1)-th load) has landed.
__device__ inline void stage_wait(Stage& s, int c) {
  const uint32_t bar = smem_addr(&s.full[c & 1]);
  const uint32_t parity = (uint32_t)((c >> 1) & 1);
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

}  // namespace fsgs
