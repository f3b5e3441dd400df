// Tile-compositing backward kernel for Hopper (sm_90a).
//
// Replaces freesurgs_tpu/ops/raster_pallas.py:_bwd_kernel (launched by
// _run_bwd; the per-Gaussian sum of _composite_bwd stays outside, in
// ops/raster_cuda.py). Same function: each 32x32 bin tile replays its
// forward front to back and, from the saved totals, writes every instance's
// gradient with respect to its 10 record fields: mean2d.xy, conic (a, b, c),
// opacity, r, g, b and z (the z channel plus 2z times the z^2 channel).
// Slots past the replay are written as zeros: the output buffer is not
// initialised.
//
// The store is in the per-Gaussian sum's order: slot s's 10 gradients are
// one contiguous 40 B row, dsum[sum_rank[s]] of a slot-major (M, 10)
// buffer, where sum_rank (ops/binning.py sum_layout) sorts the slots by
// the Gaussian they hold. So the sum after this kernel
// (gaussian_grad_sum.cu) reads each Gaussian's gradients as contiguous
// rows, not as 10 gathers of 4 B a slot from a field-major (10, M) buffer
// (each in its own 32 B sector). Each chunk's 128 ranks ride its bulk copy
// (512 B more on the same mbarrier), and 10 neighbouring threads write a
// slot's row, so a warp stores whole rows.
//
// Per pixel, with cg = sum_ch g_ch c_ch of the instance and S the running
// sum of w cg over the instances composited so far (itself included):
//   dalpha = cg T - (t0 + g_T T_final - S) / (1 - alpha),
// t0 = sum_ch g_ch out_ch being the total of all of them (suffix from the
// saved totals, no back-to-front pass). Then the chain to the fields
// through power and opacity; d(opacity) is sum dalpha exp(power)
// [raw < 0.99], computed directly.
//
// The replay reads the forward's decisions instead of remaking them: pair
// (slot i, pixel) was composited exactly when i < the pixel's stop index
// (output channel 7) and the alpha cutoffs pass (composite_common.cuh's
// pair_alpha, which the forward shares). So there is no T < 1e-4 test and
// no stop flag, T is carried as a running product T *= 1 - alpha (no exp
// or log per pair), and a warp's walk ends at its pixels' largest stop
// index, a tile's at the largest of its warps'.
//
// What bounds it on an H100: like the forward, the f32 operations of the
// pairs that need float work (a blended pair ~58 in this replay and chain,
// a cut pair ~14), against 67 TFLOP/s of non-tensor f32; pairs past a
// pixel's stop need none here, not even the stopping one. The bytes (feat,
// out, gout and sum_rank read once, dsum written once) are small beside
// them.
// The first design reached ~5% of that bound: every warp held pixels
// of all four 16 px quadrants, so rect misses cost every warp a full
// record step, and every warp reduced every record's 10 gradients with 10
// shuffle butterflies (50 shuffles). Here:
//  - a warp owns one quadrant (composite_common.cuh): a record whose rect
//    misses it, or that lies past the warp's last stop, is one uniform
//    branch with no reduction;
//  - the 10 sums of a record the warp touches are reduced by one
//    transposing butterfly (12 shuffles, reduce_scatter10), skipped when no
//    lane contributed, and land one field per lane in part[warp][j][f];
//  - after each chunk every thread sums part over the warps in warp order
//    (fixed, deterministic, no atomics) for 5 of the chunk's 1280
//    (slot, field) outputs; part is slot-major, so the butterfly's 10
//    writers and the sum's readers touch consecutive words;
//  - chunks arrive by bulk copy (TMA) into two buffers on mbarriers: chunk
//    c + 1 lands during chunk c's walk and sum.
// Shared memory is 53 KB (dynamic) and the launch bound asks for 3 CTAs
// (24 warps) per SM: ptxas fits 80 registers with a 12-byte spill.

#include "composite_common.cuh"

using namespace fsgs;

namespace {

struct BwdShared {
  Stage st;
  int rank[2][CHUNK];              // sum_rank of each buffer's slots
  float part[NWARPS][CHUNK][NF];   // per-warp record gradients of a chunk
  int smax[NWARPS];                // each warp's largest stop index
};

// One thread: stage_issue plus the chunk's ranks into rank[b], on the same
// mbarrier (its expected bytes raised first, before the arrival that
// stage_issue makes, so the phase cannot complete without them).
__device__ inline void stage_issue_ranked(BwdShared& sh, int b,
                                          const float* feat, const int* rect,
                                          const int* sum_rank, int M,
                                          int base) {
  const uint32_t bar = smem_addr(&sh.st.full[b]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"((uint32_t)(CHUNK * 4))
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(sh.rank[b])),
      "l"(sum_rank + base), "r"((uint32_t)(CHUNK * 4)), "r"(bar)
      : "memory");
  stage_issue(sh.st, b, feat, rect, M, base);
}

// Field whose total lane `lane` holds after reduce_scatter10, or -1 where
// the lane only duplicates another's (the writers are 10 distinct lanes).
__device__ inline int scatter_field(int lane) {
  if (lane & 1) return -1;
  const int g = 5 * ((lane >> 4) & 1);
  const int b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1, b1 = (lane >> 1) & 1;
  if (!b3 && !b2) return g + b1;
  if (b1) return -1;
  return g + 2 + (b3 ? 1 + b2 : 0);
}

// Sum of v[0..9] over the warp's 32 lanes, transposed: each lane ends with
// the total of field scatter_field(lane) (its partner's where that is -1).
// Each xor step halves the fields a lane keeps (5 | 5, 3 | 2, 2 | 1 or
// 1 | 1, 1 | 1) and adds the partner's partials of the kept ones: 12
// shuffles in all, in an order fixed by the lane.
__device__ inline float reduce_scatter10(const float (&v)[NF], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[5];                      // xor 16: fields 5 b4 + i
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float send = b4 ? v[i] : v[5 + i];
    a[i] = (b4 ? v[5 + i] : v[i]) + __shfl_xor_sync(FULL_MASK, send, 16);
  }
  float c[3];                      // xor 8: b3 = 0 keeps a[0..2], 1 a[3..4]
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float send = b3 ? a[s] : a[3 + s];
    c[s] = (b3 ? a[3 + s] : a[s]) + __shfl_xor_sync(FULL_MASK, send, 8);
  }
  c[2] = a[2] + __shfl_xor_sync(FULL_MASK, a[2], 8);   // b3 = 0 only
  // xor 4: (b3, b2) = (0, 0) keeps c[0], c[1]; (0, 1) c[2]; (1, 0) c[0]
  // (field 3); (1, 1) c[1] (field 4)
  const float send1 = b2 ? c[0] : (b3 ? c[1] : c[2]);
  const float keep1 = b2 ? (b3 ? c[1] : c[2]) : c[0];
  const float d0 = keep1 + __shfl_xor_sync(FULL_MASK, send1, 4);
  const float d1 = c[1] + __shfl_xor_sync(FULL_MASK, c[1], 4);  // (0, 0)
  // xor 2: (0, 0) splits d0 | d1 by b1; the others add their one field
  const bool split = !b3 && !b2;
  const float send2 = split && !b1 ? d1 : d0;
  const float keep2 = split && b1 ? d1 : d0;
  float e = keep2 + __shfl_xor_sync(FULL_MASK, send2, 2);
  return e + __shfl_xor_sync(FULL_MASK, e, 1);           // xor 1
}

// Does warp w's quadrant of the tile at 16 px (x16, y16) of its quadrant 0
// lie in the rect?
__device__ inline bool warp_hits(int rc, int w, int x16, int y16) {
  const int q = w >> 1;
  return rect_hits(rc, x16 + (q & 1), y16 + (q >> 1));
}

}  // namespace

constexpr size_t BWD_SMEM = sizeof(BwdShared);

__global__ void __launch_bounds__(NTHREADS, 3)
composite_bwd_kernel(const float* __restrict__ feat, const int* __restrict__ rect,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     const int* __restrict__ keff_in, const float* __restrict__ out,
                     const float* __restrict__ gout,
                     const int* __restrict__ sum_rank, float* __restrict__ dsum,
                     int M, int grid_x, int num_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdShared& sh = *reinterpret_cast<BwdShared*>(smem_raw);
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  const QuadPixels px = quad_pixels(tile, grid_x);
  const size_t plane = (size_t)num_tiles * NPIX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wfield = scatter_field(lane);
  const int tx16 = (tile % grid_x) * 2, ty16 = (tile / grid_x) * 2;

  // per pixel: gout of the 6 image channels, R = t0 + g_T T_final, the
  // running T and S, and the forward's stop index
  float g[PPT][6], R[PPT], T[PPT], S[PPT];
  int stop[PPT];
  int smax = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = px.gidx0 + k * px.row_stride;
    float t0 = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
      g[k][ch] = gout[ch * plane + p];
      t0 += g[k][ch] * out[ch * plane + p];
    }
    R[k] = t0 + gout[6 * plane + p] * out[6 * plane + p];
    T[k] = 1.0f;
    S[k] = 0.0f;
    stop[k] = (int)out[7 * plane + p];
    smax = max(smax, stop[k]);
  }
  smax = __reduce_max_sync(FULL_MASK, smax);
  if (lane == 0) sh.smax[warp] = smax;
  if (threadIdx.x == 0) stage_init(sh.st);
  __syncthreads();

  int n_load = 0;                 // chunks that hold a composited pair
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) n_load = max(n_load, sh.smax[w]);
  n_load = min((n_load + CHUNK - 1) / CHUNK, keff_in[tile]);
  if (threadIdx.x == 0) {
    if (n_load > 0) stage_issue_ranked(sh, 0, feat, rect, sum_rank, M, start);
    if (n_load > 1)
      stage_issue_ranked(sh, 1, feat, rect, sum_rank, M, start + CHUNK);
  }
  // slots of the chunks never composited: exact zeros, in their rows
  for (int i = n_load * CHUNK * NF + threadIdx.x; i < n_chunks * CHUNK * NF;
       i += NTHREADS) {
    const int slot = i / NF, f = i % NF;
    dsum[(size_t)__ldg(sum_rank + start + slot) * NF + f] = 0.0f;
  }

  for (int c = 0; c < n_load; ++c) {
    const int b = c & 1;
    const Records& r = sh.st.buf[b];
    stage_wait(sh.st, c);
    const int jend = min(CHUNK, smax - c * CHUNK);   // warp-uniform
    for (int j = 0; j < jend; ++j) {
      if (!rect_hits(r.rect[j], px.x16, px.y16)) continue;   // uniform
      const int i = c * CHUNK + j;
      const float ca = r.f[2][j], cb = r.f[3][j], cc = r.f[4][j];
      const float op = r.f[5][j];
      const float cr = r.f[6][j], cgr = r.f[7][j], cbl = r.f[8][j];
      const float z = r.f[9][j];
      const float dx = r.f[0][j] - px.fx;
      const float my = r.f[1][j];
      const float dxx_a = __fmul_rn(__fmul_rn(ca, dx), dx);
      const float dx_b = __fmul_rn(cb, dx);
      // over the thread's pixels: P = sum dpow, Q = sum dy dpow,
      // U = sum dy^2 dpow, then the 5 geometric gradients from them
      float P = 0.0f, Q = 0.0f, U = 0.0f;
      float v[NF];
#pragma unroll
      for (int f = 5; f < NF; ++f) v[f] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (i >= stop[k]) continue;          // past this pixel's stop
        const float dy = my - pixel_y(px, k);
        float alpha, raw, expp;
        if (!pair_alpha(dxx_a, dx_b, dy, cc, op, alpha, raw, expp)) continue;
        any = true;
        const float Tk = T[k];
        const float w = alpha * Tk;
        const float cg = g[k][0] * cr + g[k][1] * cgr + g[k][2] * cbl +
                         g[k][3] * z + g[k][4] + g[k][5] * (z * z);
        S[k] += w * cg;
        const float om = 1.0f - alpha;
        const float dalpha = cg * Tk - __fdividef(R[k] - S[k], om);
        const float dclamp = raw < ALPHA_MAX ? dalpha : 0.0f;
        const float dpow = dclamp * op * expp;
        const float ydp = dy * dpow;
        P += dpow;
        Q += ydp;
        U += dy * ydp;
        v[5] += dclamp * expp;
        v[6] += g[k][0] * w;
        v[7] += g[k][1] * w;
        v[8] += g[k][2] * w;
        v[9] += (g[k][3] + 2.0f * z * g[k][5]) * w;
        T[k] = Tk * om;
      }
      float val = 0.0f;
      if (__any_sync(FULL_MASK, any)) {
        v[0] = -(ca * dx * P + cb * Q);
        v[1] = -(cc * Q + cb * dx * P);
        v[2] = -0.5f * dx * dx * P;
        v[3] = -dx * Q;
        v[4] = -0.5f * U;
        val = reduce_scatter10(v, lane);
      }
      if (wfield >= 0) sh.part[warp][j][wfield] = val;
    }
    __syncthreads();              // part complete
    // warp w wrote slot j iff its quadrant is in the rect and j is before
    // its last stop; sum those in warp order, into slot j's row
    for (int it = threadIdx.x; it < NF * CHUNK; it += NTHREADS) {
      const int j = it / NF, f = it % NF;
      const int rc = r.rect[j];
      const int i = c * CHUNK + j;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w)
        if (i < sh.smax[w] && warp_hits(rc, w, tx16, ty16)) s += sh.part[w][j][f];
      dsum[(size_t)sh.rank[b][j] * NF + f] = s;
    }
    __syncthreads();              // part and buffer b consumed
    if (threadIdx.x == 0 && c + 2 < n_load)
      stage_issue_ranked(sh, b, feat, rect, sum_rank, M,
                         start + (c + 2) * CHUNK);
  }
}

extern "C" int composite_bwd(const float* feat, const int* rect, const int* starts,
                             const int* counts, const int* keff, const float* out,
                             const float* gout, const int* sum_rank, float* dsum,
                             int M, int grid_x, int num_tiles, void* stream) {
  static bool smem_set = false;   // above 48 KB needs the opt-in
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, NTHREADS, BWD_SMEM, (cudaStream_t)stream>>>(
        feat, rect, starts, counts, keff, out, gout, sum_rank, dsum, M, grid_x,
        num_tiles);
  }
  return (int)cudaGetLastError();
}
