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
// pre-slot index (ops/binning.py pre_rank; padding slots' rows are +0),
// 16-byte aligned; seg_lo / seg_hi (n,) int32, each Gaussian's run of
// pre-slots; scratch, its layout below (ops/raster_cuda.py
// prefix_scratch_words). Output: out (n, 10).
//
// The association order is the one jnp.cumsum takes on XLA's CPU backend
// (its reduce-window rewrite with base length 16), so that the result is
// the JAX package's bit for bit on the same rows. Level 0 is pre's M rows;
// level l + 1 holds the totals of level l's blocks of 16 (each block's
// entries added in order from +0; zeros past the end add nothing), up to
// the first level with at most 16 entries, the top. With W_l[i] the
// entries of i's block up to i added in order from +0:
//   S_top = W_top,   S_l[i] = W_l[i] + S_{l+1}[i / 16 - 1],
// the add skipped where i / 16 = 0 (the +0 it adds changes no bit of a sum
// begun at +0, which is never -0); csum[k] = S_0[k - 1], csum[0] = +0.
// For M = 824,341 rows the levels hold 51,522, 3,221, 202 and 13 entries.
// No level's scan is formed in full: each csum value is rebuilt top-down
// from one entry each of W_0, W_1, W_2 and S_3, the whole scan of level 3
// (202 entries at that M).
//
// Scratch (floats, 10 a row): W_0 (M rows), W_1 (L1), level 2's entries
// (L2), then level 3's and those of the levels above it.
//
// Two launches up to M ~ 1.2 million rows, three past it:
//  1. block_kernel, a CTA of 160 threads per 256 rows (one level-1 block):
//     its rows in 16-byte loads into shared memory, row-major with 8 pad
//     words a block of 16 rows (a thread walking one block's field then
//     shares its bank with at most one other lane), W_0 in place (a thread
//     a block and field) and out in 16-byte stores, W_1 of its 16 blocks
//     and its level-2 entry.
//  2. lookup_kernel, one CTA of 1,024 threads an SM. It issues its first
//     loads, then forms W_2 and S_3 from level 2's entries in its shared
//     memory (field-major, so that lanes on consecutive blocks hit
//     distinct banks; level 3 up scanned by one warp); then three
//     Gaussians a warp-step, ten lanes each: a lane takes one boundary's
//     csum in two fields, from one float2 of W_0 and of W_1 in device
//     memory and W_2 and S_3 in shared memory (seg_lo / seg_hi read once a
//     Gaussian); the seg_hi lanes take their partner's value by a shuffle
//     and write out[g].
//  Past ~1.2 million rows W_2 and S_3 outgrow 200 KB of shared memory:
//  upper_kernel forms them in the scratch, one CTA, between the two.
// Every add is a plain f32 add in a fixed order, no atomics: deterministic,
// equal to ops/raster_cuda.py gaussian_grad_prefix_plain.
//
// What bounds it on an H100: the bytes (pre read once, 40 B a row; seg_lo /
// seg_hi read and out written once) against 3.35 TB/s. The design moves
// ~3x those bytes: W_0 is written, and read back at two rows a Gaussian
// (64 B of sectors each) with one row of W_1 each, so that a lookup reads
// one row a level where re-reading pre cost up to 16 rows a boundary (the
// first redesign's lookup, thread a boundary, ran 3-4x slower on the L1's
// scattered lines). The rest is latency between dependent steps: the
// level-2 / level-3 combine (a few us of prologue with the CTA's first
// loads in flight; a ticket-picked last CTA or a launch of its own cost
// more) and the launch between the two kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NF = 10;
constexpr int BASE = 16;
constexpr int PAD = BASE + 1;                // words a padded block of 16
constexpr int ROWS = BASE * BASE;            // level-0 rows a block CTA
constexpr int BLOCK_THREADS = BASE * NF;     // a thread a block and field
constexpr int BLK_STRIDE = BASE * NF + 8;    // words a staged block of 16
constexpr int STAGE_WORDS = BASE * BLK_STRIDE;
constexpr int VECS = ROWS * NF / 4;          // float4s of a full CTA
constexpr int VEC_PER_THREAD = VECS / BLOCK_THREADS;   // 4
constexpr int BLOCKS_PER_SM = 12;            // 60 of an SM's 64 warps
constexpr int LOOKUP_THREADS = 1024;         // one lookup CTA an SM
constexpr int PAIRS = NF / 2;                // float2 pairs of fields a row
constexpr int G_PER_WARP = 3;                // Gaussians a lookup warp-step
constexpr int TRIPLES = 4;                   // warp-steps a lookup iteration
constexpr int MAX_LEVELS = 8;                // levels from 3 up, M < 2^31/10
constexpr int LOOKUP_SMEM_MAX = 200 * 1024;  // W_2 and S_3 in shared memory

// One block's entries p[0], p[stride], ... (n <= 16 of them) added in
// order from +0, all loads issued first: returns the total, and with
// `scan` stores the running sums in place, plus e where `add`.
__device__ __forceinline__ float chain(float* p, int stride, int n,
                                       bool scan, bool add, float e) {
  float v[BASE];
#pragma unroll
  for (int j = 0; j < BASE; ++j)
    if (j < n) v[j] = p[j * stride];
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < BASE; ++j)
    if (j < n) {
      acc += v[j];
      if (scan) p[j * stride] = add ? acc + e : acc;
    }
  return acc;
}

// The blocked scan of y (L rows of 10) in place, the levels above it
// stored after it: each level's block totals bottom up, then each level's
// blocks scanned from the top down (a thread a block and field), plus the
// scan above's entry before the block. All threads of one CTA, or with
// WARP those of its first warp alone (no CTA barriers between levels).
template <bool WARP>
__device__ void blocked_scan(float* y, int L) {
  int len[MAX_LEVELS], nl = 0;
  float* lev[MAX_LEVELS];
  float* at = y;
  for (int l = L;; l = (l + BASE - 1) / BASE) {
    len[nl] = l;
    lev[nl] = at;
    at += l * NF;
    ++nl;
    if (l <= BASE) break;
  }
  const int tid = threadIdx.x, nt = WARP ? 32 : blockDim.x;
  for (int l = 0; l + 1 < nl; ++l) {
    for (int it = tid; it < len[l + 1] * NF; it += nt) {
      const int b = it / NF, f = it - b * NF;
      lev[l + 1][it] = chain(lev[l] + b * BASE * NF + f, NF,
                             min(BASE, len[l] - b * BASE), false, false,
                             0.0f);
    }
    if (WARP) __syncwarp(); else __syncthreads();
  }
  for (int l = nl - 1; l >= 0; --l) {
    const int nb = (len[l] + BASE - 1) / BASE;
    for (int it = tid; it < nb * NF; it += nt) {
      const int b = it / NF, f = it - b * NF;
      const bool add = l + 1 < nl && b > 0;
      chain(lev[l] + b * BASE * NF + f, NF, min(BASE, len[l] - b * BASE),
            true, add, add ? lev[l + 1][(b - 1) * NF + f] : 0.0f);
    }
    if (WARP) __syncwarp(); else __syncthreads();
  }
}

// W_2 in place over level 2's entries x (l2 rows of 10); with a level 3,
// its entries at y (each level-2 block's total), then S_3 in place there.
// All threads of one CTA, in device memory (upper_kernel).
__device__ void upper_levels(float* x, int l2, float* y, int levels) {
  const int nb = (l2 + BASE - 1) / BASE;
  for (int it = threadIdx.x; it < nb * NF; it += blockDim.x) {
    const int b = it / NF, f = it - b * NF;
    const float total = chain(x + b * BASE * NF + f, NF,
                              min(BASE, l2 - b * BASE), true, false, 0.0f);
    if (levels >= 3) y[it] = total;
  }
  __syncthreads();
  if (levels >= 3) blocked_scan<false>(y, nb);
}

// A row-major index within the CTA's rows -> its staged word.
__device__ inline int staged(int q) {
  const int b = q / (BASE * NF);
  return b * BLK_STRIDE + (q - b * BASE * NF);
}

// One CTA per ROWS rows (levels: the number of levels above level 0):
// W_0, W_1 and the level-2 entry of its rows.
__global__ void __launch_bounds__(BLOCK_THREADS, BLOCKS_PER_SM)
block_kernel(const float* __restrict__ pre, int m, float* __restrict__ w0,
             float* __restrict__ w1, float* __restrict__ t2, int levels) {
  __shared__ __align__(16) float sx[STAGE_WORDS];
  __shared__ float st1[NF * PAD];
  const int tid = threadIdx.x, c = blockIdx.x;
  const int rows = min(ROWS, m - c * ROWS);
  const int words = rows * NF, vecs = words >> 2;
  const size_t base = (size_t)c * ROWS * NF;

  // the rows, 16 B a load, every load issued before the stores
  const float4* src4 = reinterpret_cast<const float4*>(pre + base);
  float4 v[VEC_PER_THREAD];
#pragma unroll
  for (int k = 0; k < VEC_PER_THREAD; ++k) {
    const int i = tid + k * BLOCK_THREADS;
    if (i < vecs) v[k] = __ldg(src4 + i);
  }
#pragma unroll
  for (int k = 0; k < VEC_PER_THREAD; ++k) {
    const int i = tid + k * BLOCK_THREADS;
    if (i < vecs) *reinterpret_cast<float4*>(sx + staged(4 * i)) = v[k];
  }
  for (int q = 4 * vecs + tid; q < words; q += BLOCK_THREADS)
    sx[staged(q)] = pre[base + q];
  __syncthreads();

  // W_0 in place and the level-1 totals
  const int nb0 = (rows + BASE - 1) / BASE;
  {
    const int b = tid / NF, f = tid - b * NF;
    if (b < nb0)
      st1[f * PAD + b] = chain(sx + b * BLK_STRIDE + f, NF,
                               min(BASE, rows - b * BASE), true, false,
                               0.0f);
  }
  __syncthreads();

  // W_1 and the level-2 entry; W_0 out, 16 B a store
  if (tid < NF) {
    const float total = chain(st1 + tid * PAD, 1, nb0, true, false, 0.0f);
    if (levels >= 2) t2[c * NF + tid] = total;
  }
  float4* dst4 = reinterpret_cast<float4*>(w0 + base);
#pragma unroll
  for (int k = 0; k < VEC_PER_THREAD; ++k) {
    const int i = tid + k * BLOCK_THREADS;
    if (i < vecs)
      dst4[i] = *reinterpret_cast<const float4*>(sx + staged(4 * i));
  }
  for (int q = 4 * vecs + tid; q < words; q += BLOCK_THREADS)
    w0[base + q] = sx[staged(q)];
  __syncthreads();
  if (tid < nb0 * NF) {
    const int e = tid / NF, f = tid - e * NF;
    w1[(size_t)c * BASE * NF + tid] = st1[f * PAD + e];
  }
}

// W_2 and S_3 in place in the scratch, where they outgrow the lookup's
// shared memory: one CTA.
__global__ void __launch_bounds__(LOOKUP_THREADS)
upper_kernel(float* t2, int l2, float* t3, int levels) {
  upper_levels(t2, l2, t3, levels);
}

// One boundary's csum in two fields (2h, 2h + 1), in two steps: the rows
// of device memory (W_0[k - 1] and W_1's), then S_1 completed from W_2 and
// S_3, which the lookup may form meanwhile.
struct Csum {
  float2 a, e1;   // W_0[k - 1]; W_1[k / 16 - 2] (S_1 once completed)
  int j1, j2;     // rows of W_1 and W_2 (-1: none)
};

__device__ __forceinline__ Csum csum_load(const float2* __restrict__ w0,
                                          const float2* __restrict__ w1,
                                          int levels, int k, int h) {
  Csum c;
  c.a = make_float2(0.0f, 0.0f);
  c.e1 = c.a;
  c.j1 = c.j2 = -1;
  if (k <= 0) return c;
  const int i = k - 1;
  c.a = __ldg(w0 + (size_t)i * PAIRS + h);
  if (levels >= 1 && (i >> 4) > 0) {
    c.j1 = (i >> 4) - 1;
    c.e1 = __ldg(w1 + (size_t)c.j1 * PAIRS + h);
    if (levels >= 2 && (c.j1 >> 4) > 0) c.j2 = (c.j1 >> 4) - 1;
  }
  return c;
}

// S_0[k - 1] = W_0 + (W_1 + (W_2 + S_3)), each add where its level has an
// entry before the block (the order of blocked_scan_plain). W_2 is w2's
// rows in device memory, or with w2s its field-major copy in shared
// memory (field stride xs, 17 words a block of 16); S_3 is s3's rows, in
// either.
__device__ __forceinline__ float2 csum_finish(Csum c, const float2* w2,
                                              const float* w2s, int xs,
                                              const float2* s3, int levels,
                                              int h) {
  if (c.j1 < 0) return c.a;
  if (c.j2 >= 0) {
    float2 e2;
    if (w2s != nullptr) {
      const float* p = w2s + 2 * h * xs + (c.j2 >> 4) * PAD + (c.j2 & 15);
      e2 = make_float2(p[0], p[xs]);
    } else {
      e2 = w2[(size_t)c.j2 * PAIRS + h];
    }
    const int j3 = (c.j2 >> 4) - 1;
    if (levels >= 3 && j3 >= 0) {
      const float2 e3 = s3[(size_t)j3 * PAIRS + h];
      e2.x += e3.x;
      e2.y += e3.y;
    }
    c.e1.x += e2.x;
    c.e1.y += e2.y;
  }
  return make_float2(c.a.x + c.e1.x, c.a.y + c.e1.y);
}

// The loads of one lookup iteration: TRIPLES steps, three Gaussians each.
__device__ __forceinline__ void load_step(
    int step, int slot, bool hi, int h, const float2* __restrict__ w0,
    const float2* __restrict__ w1, int levels,
    const int* __restrict__ seg_lo, const int* __restrict__ seg_hi, int n,
    int (&g)[TRIPLES], Csum (&c)[TRIPLES]) {
#pragma unroll
  for (int t = 0; t < TRIPLES; ++t) {
    g[t] = (step * TRIPLES + t) * G_PER_WARP + slot;
    int k = 0;
    if (slot < G_PER_WARP && g[t] < n)
      k = hi ? __ldg(seg_hi + g[t]) : __ldg(seg_lo + g[t]);
    c[t] = csum_load(w0, w1, levels, k, h);
  }
}

// One CTA an SM, three Gaussians a warp-step, ten lanes each: lanes 0-4
// take seg_lo's csum, lanes 5-9 seg_hi's, a pair of fields a lane (lanes
// 30 and 31 idle); TRIPLES steps an iteration, their loads issued
// together. With `shared` the CTA first forms W_2 and S_3 from level 2's
// entries t2 in its shared memory, while its first loads are in flight;
// else t2 and t3 hold them.
__global__ void __launch_bounds__(LOOKUP_THREADS, 1)
lookup_kernel(const float2* __restrict__ w0, const float2* __restrict__ w1,
              const float* t2, const float* t3, int l2, int levels,
              int shared, const int* __restrict__ seg_lo,
              const int* __restrict__ seg_hi, float2* __restrict__ out,
              int n) {
  extern __shared__ float4 lsm[];
  const int lane = threadIdx.x & 31;
  const int slot = lane / (2 * PAIRS), r = lane % (2 * PAIRS);
  const bool hi = r >= PAIRS;
  const int h = r % PAIRS;
  const int partner = slot == G_PER_WARP ? lane : hi ? lane - PAIRS
                                                     : lane + PAIRS;
  const int warps = gridDim.x * (LOOKUP_THREADS / 32);
  int step = blockIdx.x * (LOOKUP_THREADS / 32) + (threadIdx.x >> 5);
  int g[TRIPLES];
  Csum c[TRIPLES];
  load_step(step, slot, hi, h, w0, w1, levels, seg_lo, seg_hi, n, g, c);

  const float2* w2 = reinterpret_cast<const float2*>(t2);
  const float2* s3 = reinterpret_cast<const float2*>(t3);
  const float* w2s = nullptr;
  const int nb = (l2 + BASE - 1) / BASE, xs = nb * PAD | 1;
  if (shared) {
    // level 2's entries field-major, 17 words a block of 16 and an odd
    // field stride: the lanes walking consecutive blocks of one field hit
    // distinct banks
    float* x = reinterpret_cast<float*>(lsm);
    float* y = x + NF * xs;
    constexpr int U = 8;   // loads a thread issues before its stores
    for (int q0 = threadIdx.x; q0 < l2 * NF; q0 += U * LOOKUP_THREADS) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * LOOKUP_THREADS;
        if (q < l2 * NF) v[u] = __ldg(t2 + q);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * LOOKUP_THREADS;
        const int e = q / NF, f = q - e * NF;
        if (q < l2 * NF) x[f * xs + (e >> 4) * PAD + (e & 15)] = v[u];
      }
    }
    __syncthreads();
    for (int it = threadIdx.x; it < nb * NF; it += LOOKUP_THREADS) {
      const int f = it / nb, b = it - f * nb;
      const float total = chain(x + f * xs + b * PAD, 1,
                                min(BASE, l2 - b * BASE), true, false, 0.0f);
      if (levels >= 3) y[b * NF + f] = total;
    }
    __syncthreads();
    // level 3 and up (a few hundred rows where they fit here): one warp,
    // which needs no CTA barrier between the levels
    if (levels >= 3 && threadIdx.x < 32) blocked_scan<true>(y, nb);
    __syncthreads();
    w2s = x;
    s3 = reinterpret_cast<const float2*>(y);
  }

  while (step * TRIPLES * G_PER_WARP < n) {
#pragma unroll
    for (int t = 0; t < TRIPLES; ++t) {
      const float2 v = csum_finish(c[t], w2, w2s, xs, s3, levels, h);
      const float ox = __shfl_sync(0xffffffffu, v.x, partner);
      const float oy = __shfl_sync(0xffffffffu, v.y, partner);
      if (slot < G_PER_WARP && g[t] < n && hi)
        out[(size_t)g[t] * PAIRS + h] = make_float2(v.x - ox, v.y - oy);
    }
    step += warps;
    load_step(step, slot, hi, h, w0, w1, levels, seg_lo, seg_hi, n, g, c);
  }
}

inline long ceil_div(long a, long b) { return (a + b - 1) / b; }

}  // namespace

// scratch_words: the floats the caller allocated, checked against the
// layout's need (ops/raster_cuda.py prefix_scratch_words).
extern "C" int gaussian_grad_prefix(const float* pre, const int* seg_lo,
                                    const int* seg_hi, float* scratch,
                                    float* out, int m, int n,
                                    int scratch_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  int levels = 0;
  for (long l = m; l > BASE; l = ceil_div(l, BASE)) ++levels;
  const long l1 = ceil_div(m, BASE), l2 = ceil_div(l1, BASE);
  long up = 0;   // level 3 and the levels above it
  for (long l = ceil_div(l2, BASE);; l = ceil_div(l, BASE)) {
    up += l;
    if (l <= BASE) break;
  }
  if (((long)m + l1 + l2 + up) * NF > (long)scratch_words)
    return (int)cudaErrorInvalidValue;
  float* w0 = scratch;
  float* w1 = w0 + (size_t)m * NF;
  float* t2 = w1 + l1 * NF;
  float* t3 = t2 + l2 * NF;
  static int sms = 0;   // and the lookup's opt-in above 48 KB, once
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(lookup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LOOKUP_SMEM_MAX);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  if (m > 0)
    block_kernel<<<(int)l2, BLOCK_THREADS, 0, st>>>(pre, m, w0, w1, t2,
                                                    levels);
  // W_2 and S_3: in the lookup's shared memory where they fit
  const long smem = levels >= 2 ? (NF * (ceil_div(l2, BASE) * PAD | 1)
                                   + (levels >= 3 ? up * NF : 0)) * 4
                                : 0;
  const int shared = levels >= 2 && smem <= LOOKUP_SMEM_MAX;
  if (levels >= 2 && !shared)
    upper_kernel<<<1, LOOKUP_THREADS, 0, st>>>(t2, (int)l2, t3, levels);
  const long per_cta = (LOOKUP_THREADS / 32) * TRIPLES * G_PER_WARP;
  lookup_kernel<<<(int)std::min<long>(sms, ceil_div(n, per_cta)),
                  LOOKUP_THREADS, shared ? smem : 0, st>>>(
      reinterpret_cast<const float2*>(w0), reinterpret_cast<const float2*>(w1),
      t2, t3, (int)l2, levels, shared, seg_lo, seg_hi,
      reinterpret_cast<float2*>(out), n);
  return (int)cudaGetLastError();
}
