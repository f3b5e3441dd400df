// The per-Gaussian projection, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's projection
// (freesurgs_tpu/ops/render.py render: world->camera, ops/projection.py
// project_gaussians, core/sh.py sh_to_rgb_clamped) is a jnp chain that XLA
// fuses by itself. Run op by op, the port's plain version
// (ops/project_cuda.py raster_inputs_plain) issued ~270 PyTorch launches
// forward and ~500 autograd launches backward per render, each a few
// microseconds of device work behind ~25 us of the host's time. Here the
// forward is one launch, the backward one launch, plus, only when the pose
// needs a gradient, one small reduction (project_pose_kernel).
//
// project_fwd_kernel computes everything ops/render.py _raster_inputs
// returns: mean2d (+ the densify probe), conic, radius, the 16 px tile rect
// and its tile count, rgbz (SH -> RGB against the origin, + depth) and the
// opacity. project_bwd_kernel takes the cotangents of mean2d, conic, rgbz
// and opacity and writes the gradients of the means, quaternions, log
// scales, logit opacities and SH coefficients (GS), and per block the
// partial sums of the pose gradient (d w2c = sum_i d mean_cam_i (p_i, 1)^T),
// which project_pose_kernel adds in a fixed order. It recomputes the
// forward's intermediates from the inputs instead of saving them: they
// would be ~200 B a Gaussian each way, more than the inputs it reads again.
// The gradients follow the plain version's autograd semantics edge by edge
// (ops/project_cuda.py project_bwd_plain is this backward in PyTorch, line
// by line): torch.maximum splits the gradient 0.5 / 0.5 at a tie, clamp and
// clamp_min pass it on their inclusive side, det == 0 and z == 0 take their
// constant branches, and nothing flows through radius or the visibility.
//
// Rounding. The integer outputs (radius, tile rect, tiles touched) turn
// floats into integers, and a one-ulp difference can move a rect: the
// binning would then see another layout than the plain version's. So the
// forward's projection rounds op by op as the plain version's PyTorch ops
// do on the card (the f* helpers below are __f*_rn intrinsics, which nvcc
// never contracts into an fma): the same constants, each scalar rounded to
// float32 as PyTorch rounds a Python scalar, x / 16 as PyTorch's x * (1 /
// 16), a Python float over a tensor as its reciprocal times the float,
// cuBLAS's order for the two 3-term products (mean_cam and R S S^T R^T: an
// fma chain from the first product), and the order of PyTorch's reduction
// over the quaternion's 4 squares ((q0^2 + q2^2) + (q1^2 + q3^2)); all three
// read bit-equal on an H100 (torch 2.11, CUDA 12.8). chip_smoke.py holds
// radius, rect and tiles bit-equal to the plain version on the card. The
// backward needs no such care: its outputs are gradients.
//
// What bounds it on an H100: the bytes. At N = 131,072 and SH degree 3 the
// forward reads 245 B a Gaussian (means 12, quaternion 16, log scales 12,
// logit opacity 4, the 48 SH floats 192, active 1, probe 8) and writes 64,
// ~40 MB, 12 us at 3.35 TB/s; the backward reads the inputs and 40 B of
// cotangents and writes 236 B of gradients, ~67 MB, 20 us. The arithmetic
// (a few hundred flops a Gaussian forward, about a thousand backward, under
// 2 us at 67 TFLOP/s) is far below that.
// The design: one thread per Gaussian, nothing shared between Gaussians;
// the 192 B of SH coefficients move in 16-byte loads and stores (rows of
// 3K floats with 3K % 4 == 0 and 16-byte aligned; otherwise 4-byte); the
// cotangents are read through their row strides, so the strided views that
// autograd hands over (the compositing backward's (n, 10) sums) cost no
// copy. The pose gradient is reduced without atomics: each block adds its
// 256 Gaussians' 12 terms by a fixed tree in shared memory, and one block
// adds the blocks' partials in a fixed order, so training stays bitwise
// reproducible from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace fsgs_project {

constexpr int THREADS = 256;
constexpr int POSE_TERMS = 12;      // d w2c[a][k] (9), then d w2c[a][3] (3)

struct Cam {
  float fx, fy, cx, cy;
  float limx, limy;                 // 1.3 tan(fov), the EWA clamp
  float near_cull;
  int grid_x, grid_y;               // 16 px tiles
};

// f32 ops rounded one by one, as separate PyTorch ops round
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fsqrt(float a) { return __fsqrt_rn(a); }

// torch.clamp_min / torch.clamp with scalars: NaN passes through
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// ops/projection.py to_int32: NaN -> 0, clipped to +/-1e9, truncated
__device__ __forceinline__ int to_int32(float v) {
  if (isnan(v)) v = 0.0f;
  return (int)fminf(fmaxf(v, -1e9f), 1e9f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// SH constants (core/sh.py), rounded to f32 as PyTorch rounds them
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;
constexpr float C4_0 = 2.5033429417967046f, C4_1 = -1.7701307697799304f,
                C4_2 = 0.9461746957575601f, C4_3 = -0.6690465435572892f,
                C4_4 = 0.10578554691520431f, C4_5 = -0.6690465435572892f,
                C4_6 = 0.47308734787878004f, C4_7 = -1.7701307697799304f,
                C4_8 = 0.6258357354491761f;

template <int DEG>
struct NumCoeffs {
  static constexpr int value = (DEG + 1) * (DEG + 1);
};

// The projection's intermediates for one Gaussian (forward order).
struct Geo {
  float x, y, z;                    // camera-frame mean
  float qw, qx, qy, qz, qnorm, qc;  // normalized quaternion, |q|, max(|q|, eps)
  float R[9];                       // rotation, row-major
  float s[3];                       // exp(log_scales)
  float S00, S01, S02, S11, S12, S22;   // R S S^T R^T
  float zp, xr, yr, tx, ty;         // z (0 -> 1e-6), x / zp, clamped ratios
  float rz, zz, j00, j02, j11, j12; // 1 / zp, zp^2, the EWA Jacobian
  float a0, a1, a2, b1, b2;         // J Sigma, rows
  float ca, cb, cc, det, dsafe;     // cov2d + 0.3, its determinant
  float zs, px, py;                 // z (|z| < 1e-8 -> 1e-8), pixel mean
};

__device__ __forceinline__ void geometry(const float* __restrict__ w2c, float p0,
                                         float p1, float p2, const float q[4],
                                         const float ls[3], const Cam& cam,
                                         Geo& g) {
  // transform_points: pts @ R^T (cuBLAS: an fma chain over k) + t
  float mc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* r = w2c + 4 * a;
    mc[a] = fadd(__fmaf_rn(p2, r[2], __fmaf_rn(p1, r[1], fmul(p0, r[0]))), r[3]);
  }
  g.x = mc[0];
  g.y = mc[1];
  g.z = mc[2];

  // quat_normalize, quat_to_rotmat
  // torch.linalg.norm over 4: two threads of PyTorch's reduction, (0, 2)
  // and (1, 3), then their sum
  g.qnorm = fsqrt(fadd(fadd(fmul(q[0], q[0]), fmul(q[2], q[2])),
                       fadd(fmul(q[1], q[1]), fmul(q[3], q[3]))));
  g.qc = clamp_lo(g.qnorm, 1e-12f);
  const float w = fdiv(q[0], g.qc), x = fdiv(q[1], g.qc);
  const float y = fdiv(q[2], g.qc), z = fdiv(q[3], g.qc);
  g.qw = w;
  g.qx = x;
  g.qy = y;
  g.qz = z;
  g.R[0] = fsub(1.0f, fmul(2.0f, fadd(fmul(y, y), fmul(z, z))));
  g.R[1] = fmul(2.0f, fsub(fmul(x, y), fmul(w, z)));
  g.R[2] = fmul(2.0f, fadd(fmul(x, z), fmul(w, y)));
  g.R[3] = fmul(2.0f, fadd(fmul(x, y), fmul(w, z)));
  g.R[4] = fsub(1.0f, fmul(2.0f, fadd(fmul(x, x), fmul(z, z))));
  g.R[5] = fmul(2.0f, fsub(fmul(y, z), fmul(w, x)));
  g.R[6] = fmul(2.0f, fsub(fmul(x, z), fmul(w, y)));
  g.R[7] = fmul(2.0f, fadd(fmul(y, z), fmul(w, x)));
  g.R[8] = fsub(1.0f, fmul(2.0f, fadd(fmul(x, x), fmul(y, y))));

  // build_cov3d: M = R * s (columns), Sigma = M @ M^T (cuBLAS fma chain)
#pragma unroll
  for (int j = 0; j < 3; ++j) g.s[j] = expf(ls[j]);
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[3 * i + j] = fmul(g.R[3 * i + j], g.s[j]);
  auto dot3 = [&](int i, int j) {
    return __fmaf_rn(M[3 * i + 2], M[3 * j + 2],
                     __fmaf_rn(M[3 * i + 1], M[3 * j + 1],
                               fmul(M[3 * i], M[3 * j])));
  };
  g.S00 = dot3(0, 0);
  g.S01 = dot3(0, 1);
  g.S02 = dot3(0, 2);
  g.S11 = dot3(1, 1);
  g.S12 = dot3(1, 2);
  g.S22 = dot3(2, 2);

  // ewa_cov2d
  g.zp = g.z == 0.0f ? 1e-6f : g.z;
  g.xr = fdiv(g.x, g.zp);
  g.yr = fdiv(g.y, g.zp);
  g.tx = clamp2(g.xr, -cam.limx, cam.limx);
  g.ty = clamp2(g.yr, -cam.limy, cam.limy);
  const float xc = fmul(g.tx, g.zp), yc = fmul(g.ty, g.zp);
  g.rz = fdiv(1.0f, g.zp);                       // fx / z = z.reciprocal() * fx
  g.zz = fmul(g.zp, g.zp);
  g.j00 = fmul(g.rz, cam.fx);
  g.j02 = fdiv(fmul(xc, -cam.fx), g.zz);
  g.j11 = fmul(g.rz, cam.fy);
  g.j12 = fdiv(fmul(yc, -cam.fy), g.zz);
  g.a0 = fadd(fmul(g.j00, g.S00), fmul(g.j02, g.S02));
  g.a1 = fadd(fmul(g.j00, g.S01), fmul(g.j02, g.S12));
  g.a2 = fadd(fmul(g.j00, g.S02), fmul(g.j02, g.S22));
  g.b1 = fadd(fmul(g.j11, g.S11), fmul(g.j12, g.S12));
  g.b2 = fadd(fmul(g.j11, g.S12), fmul(g.j12, g.S22));
  g.ca = fadd(fadd(fmul(g.a0, g.j00), fmul(g.a2, g.j02)), 0.3f);
  g.cb = fadd(fmul(g.a1, g.j11), fmul(g.a2, g.j12));
  g.cc = fadd(fadd(fmul(g.b1, g.j11), fmul(g.b2, g.j12)), 0.3f);

  // project_gaussians: pixel mean and the conic's determinant
  g.zs = fabsf(g.z) < 1e-8f ? 1e-8f : g.z;
  g.px = fsub(fadd(fdiv(fmul(g.x, cam.fx), g.zs), cam.cx), 0.5f);
  g.py = fsub(fadd(fdiv(fmul(g.y, cam.fy), g.zs), cam.cy), 0.5f);
  g.det = fsub(fmul(g.ca, g.cc), fmul(g.cb, g.cb));
  g.dsafe = g.det == 0.0f ? 1.0f : g.det;
}

// SH view direction against the origin: p * rsqrt(max(|p|^2, 1e-16)).
struct Dir {
  float n2, r, x, y, z;
};

__device__ __forceinline__ void view_dir(float p0, float p1, float p2, Dir& d) {
  d.n2 = fadd(fadd(fmul(p0, p0), fmul(p2, p2)), fmul(p1, p1));  // (0, 2), (1)
  d.r = rsqrtf(clamp_lo(d.n2, 1e-16f));
  d.x = fmul(p0, d.r);
  d.y = fmul(p1, d.r);
  d.z = fmul(p2, d.r);
}

// The SH basis at a unit direction, in core/sh.py eval_sh's order of
// rounding: b[k] is the factor that multiplies coefficient k.
template <int DEG>
__device__ __forceinline__ void sh_basis(const Dir& d, float* b) {
  const float x = d.x, y = d.y, z = d.z;
  b[0] = C0;
  if (DEG > 0) {
    b[1] = -fmul(C1, y);                // result - (C1 y) sh1
    b[2] = fmul(C1, z);
    b[3] = -fmul(C1, x);
  }
  if (DEG > 1) {
    const float xx = fmul(x, x), yy = fmul(y, y), zz = fmul(z, z);
    const float xy = fmul(x, y), yz = fmul(y, z), xz = fmul(x, z);
    b[4] = fmul(C2_0, xy);
    b[5] = fmul(C2_1, yz);
    b[6] = fmul(C2_2, fsub(fsub(fmul(2.0f, zz), xx), yy));
    b[7] = fmul(C2_3, xz);
    b[8] = fmul(C2_4, fsub(xx, yy));
    if (DEG > 2) {
      b[9] = fmul(fmul(C3_0, y), fsub(fmul(3.0f, xx), yy));
      b[10] = fmul(fmul(C3_1, xy), z);
      b[11] = fmul(fmul(C3_2, y), fsub(fsub(fmul(4.0f, zz), xx), yy));
      b[12] = fmul(fmul(C3_3, z), fsub(fsub(fmul(2.0f, zz), fmul(3.0f, xx)),
                                       fmul(3.0f, yy)));
      b[13] = fmul(fmul(C3_4, x), fsub(fsub(fmul(4.0f, zz), xx), yy));
      b[14] = fmul(fmul(C3_5, z), fsub(xx, yy));
      b[15] = fmul(fmul(C3_6, x), fsub(xx, fmul(3.0f, yy)));
    }
    if (DEG > 3) {
      b[16] = fmul(fmul(C4_0, xy), fsub(xx, yy));
      b[17] = fmul(fmul(C4_1, yz), fsub(fmul(3.0f, xx), yy));
      b[18] = fmul(fmul(C4_2, xy), fsub(fmul(7.0f, zz), 1.0f));
      b[19] = fmul(fmul(C4_3, yz), fsub(fmul(7.0f, zz), 3.0f));
      b[20] = fmul(C4_4, fadd(fmul(zz, fsub(fmul(35.0f, zz), 30.0f)), 3.0f));
      b[21] = fmul(fmul(C4_5, xz), fsub(fmul(7.0f, zz), 3.0f));
      b[22] = fmul(fmul(C4_6, fsub(xx, yy)), fsub(fmul(7.0f, zz), 1.0f));
      b[23] = fmul(fmul(C4_7, xz), fsub(xx, fmul(3.0f, yy)));
      b[24] = fmul(C4_8, fsub(fmul(xx, fsub(xx, fmul(3.0f, yy))),
                              fmul(yy, fsub(fmul(3.0f, xx), yy))));
    }
  }
}

// One channel's eval_sh(...) + 0.5 from the coefficients c (3 a row) and
// the basis b, in eval_sh's order: result - (C1 y) sh1 + (C1 z) sh2 -
// (C1 x) sh3, then each further term added.
template <int DEG>
__device__ __forceinline__ float sh_channel(const float* c, const float* b,
                                            int ch) {
  float v = fmul(C0, c[ch]);
#pragma unroll
  for (int k = 1; k < NumCoeffs<DEG>::value; ++k) {
    if (k == 1 || k == 3)
      v = fsub(v, fmul(-b[k], c[3 * k + ch]));
    else
      v = fadd(v, fmul(b[k], c[3 * k + ch]));
  }
  return fadd(v, 0.5f);
}

// The SH basis's derivatives along x, y, z, each weighted by w[k] and
// summed: (sum_k w_k db_k/dx, .../dy, .../dz).
template <int DEG>
__device__ __forceinline__ void sh_basis_grad(const Dir& d, const float* w,
                                              float& gx, float& gy, float& gz) {
  const float x = d.x, y = d.y, z = d.z;
  gx = gy = gz = 0.0f;
  if (DEG > 0) {
    gx -= C1 * w[3];
    gy -= C1 * w[1];
    gz += C1 * w[2];
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gx += C2_0 * y * w[4] - 2.0f * C2_2 * x * w[6] + C2_3 * z * w[7]
          + 2.0f * C2_4 * x * w[8];
    gy += C2_0 * x * w[4] + C2_1 * z * w[5] - 2.0f * C2_2 * y * w[6]
          - 2.0f * C2_4 * y * w[8];
    gz += C2_1 * y * w[5] + 4.0f * C2_2 * z * w[6] + C2_3 * x * w[7];
    if (DEG > 2) {
      gx += 6.0f * C3_0 * x * y * w[9] + C3_1 * y * z * w[10]
            - 2.0f * C3_2 * x * y * w[11] - 6.0f * C3_3 * x * z * w[12]
            + C3_4 * (4.0f * zz - 3.0f * xx - yy) * w[13]
            + 2.0f * C3_5 * x * z * w[14] + 3.0f * C3_6 * (xx - yy) * w[15];
      gy += 3.0f * C3_0 * (xx - yy) * w[9] + C3_1 * x * z * w[10]
            + C3_2 * (4.0f * zz - xx - 3.0f * yy) * w[11]
            - 6.0f * C3_3 * y * z * w[12] - 2.0f * C3_4 * x * y * w[13]
            - 2.0f * C3_5 * y * z * w[14] - 6.0f * C3_6 * x * y * w[15];
      gz += C3_1 * x * y * w[10] + 8.0f * C3_2 * y * z * w[11]
            + C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * w[12]
            + 8.0f * C3_4 * x * z * w[13] + C3_5 * (xx - yy) * w[14];
    }
    if (DEG > 3) {
      gx += C4_0 * y * (3.0f * xx - yy) * w[16] + 6.0f * C4_1 * x * y * z * w[17]
            + C4_2 * y * (7.0f * zz - 1.0f) * w[18]
            + C4_5 * z * (7.0f * zz - 3.0f) * w[21]
            + 2.0f * C4_6 * x * (7.0f * zz - 1.0f) * w[22]
            + 3.0f * C4_7 * z * (xx - yy) * w[23]
            + 4.0f * C4_8 * x * (xx - 3.0f * yy) * w[24];
      gy += C4_0 * x * (xx - 3.0f * yy) * w[16]
            + 3.0f * C4_1 * z * (xx - yy) * w[17]
            + C4_2 * x * (7.0f * zz - 1.0f) * w[18]
            + C4_3 * z * (7.0f * zz - 3.0f) * w[19]
            - 2.0f * C4_6 * y * (7.0f * zz - 1.0f) * w[22]
            - 6.0f * C4_7 * x * y * z * w[23]
            + 4.0f * C4_8 * y * (yy - 3.0f * xx) * w[24];
      gz += C4_1 * y * (3.0f * xx - yy) * w[17] + 14.0f * C4_2 * x * y * z * w[18]
            + C4_3 * y * (21.0f * zz - 3.0f) * w[19]
            + C4_4 * z * (140.0f * zz - 60.0f) * w[20]
            + C4_5 * x * (21.0f * zz - 3.0f) * w[21]
            + 14.0f * C4_6 * z * (xx - yy) * w[22]
            + C4_7 * x * (xx - 3.0f * yy) * w[23];
    }
  }
}

// Load the first 3 * NumCoeffs<DEG> SH floats of one Gaussian's row.
template <int DEG>
__device__ __forceinline__ void load_sh(const float* __restrict__ row, bool vec,
                                        float* c) {
  constexpr int NC = 3 * NumCoeffs<DEG>::value;
  if (vec) {
    constexpr int NV = (NC + 3) / 4;
    float v[4 * NV];
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 t = __ldg(r4 + i);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) c[i] = v[i];
  } else {
#pragma unroll
    for (int i = 0; i < NC; ++i) c[i] = __ldg(row + i);
  }
}

}  // namespace fsgs_project

using namespace fsgs_project;

template <int DEG>
__global__ void __launch_bounds__(THREADS)
project_fwd_kernel(const float* __restrict__ means, const float* __restrict__ w2c,
                   const float* __restrict__ quats,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ logit_opacity,
                   const float* __restrict__ sh, const uint8_t* __restrict__ active,
                   const float* __restrict__ probe, Cam cam, int n, int sh_row,
                   int sh_vec, float* __restrict__ mean2d, float* __restrict__ conic,
                   int* __restrict__ radius, int4* __restrict__ tile_rect,
                   int* __restrict__ tiles_touched, float4* __restrict__ rgbz,
                   float* __restrict__ opacity) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float p0 = means[3 * i], p1 = means[3 * i + 1], p2 = means[3 * i + 2];
  const float4 q4 = __ldg(reinterpret_cast<const float4*>(quats) + i);
  const float q[4] = {q4.x, q4.y, q4.z, q4.w};
  const float ls[3] = {log_scales[3 * i], log_scales[3 * i + 1],
                       log_scales[3 * i + 2]};
  Geo g;
  geometry(w2c, p0, p1, p2, q, ls, cam, g);

  // conic, radius, visibility, tile rect (project_gaussians)
  conic[3 * i] = fdiv(g.cc, g.dsafe);
  conic[3 * i + 1] = fdiv(-g.cb, g.dsafe);
  conic[3 * i + 2] = fdiv(g.ca, g.dsafe);
  const float mid = fmul(0.5f, fadd(g.ca, g.cc));
  const float lam1 =
      fadd(mid, fsqrt(clamp_lo(fsub(fmul(mid, mid), g.det), 0.1f)));
  const float r = ceilf(fmul(3.0f, fsqrt(clamp_lo(lam1, 0.0f))));
  bool visible = g.z > cam.near_cull && g.det > 0.0f;
  if (active != nullptr) visible = visible && active[i] != 0;
  const int tx0 = clampi(to_int32(fmul(fsub(g.px, r), 0.0625f)), 0, cam.grid_x);
  const int ty0 = clampi(to_int32(fmul(fsub(g.py, r), 0.0625f)), 0, cam.grid_y);
  const int tx1 = clampi(
      to_int32(fmul(fsub(fadd(fadd(g.px, r), 16.0f), 1.0f), 0.0625f)), 0,
      cam.grid_x);
  const int ty1 = clampi(
      to_int32(fmul(fsub(fadd(fadd(g.py, r), 16.0f), 1.0f), 0.0625f)), 0,
      cam.grid_y);
  const int tiles = (tx1 - tx0) * (ty1 - ty0);
  visible = visible && tiles > 0;
  radius[i] = visible ? (int)r : 0;
  tiles_touched[i] = visible ? tiles : 0;
  tile_rect[i] = visible ? make_int4(tx0, ty0, tx1, ty1) : make_int4(0, 0, 0, 0);

  float mx = g.px, my = g.py;
  if (probe != nullptr) {
    mx = fadd(mx, probe[2 * i]);
    my = fadd(my, probe[2 * i + 1]);
  }
  mean2d[2 * i] = mx;
  mean2d[2 * i + 1] = my;
  opacity[i] = fdiv(1.0f, fadd(1.0f, expf(-logit_opacity[i])));

  // SH -> RGB, + 0.5, max(., 0) (sh_to_rgb_clamped), in eval_sh's order
  constexpr int NK = NumCoeffs<DEG>::value;
  float c[3 * NK];
  load_sh<DEG>(sh + (size_t)i * sh_row, sh_vec, c);
  Dir d;
  view_dir(p0, p1, p2, d);
  float b[NK];
  sh_basis<DEG>(d, b);
  float rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v = sh_channel<DEG>(c, b, ch);
    rgb[ch] = isnan(v) ? v : fmaxf(v, 0.0f);
  }
  rgbz[i] = make_float4(rgb[0], rgb[1], rgb[2], g.z);
}

// Gradients of one Gaussian. GS: write the Gaussian's own gradients; pose
// partials: dmc (p, 1) summed over the block, when pose_part is non-null.
template <int DEG, bool GS>
__global__ void __launch_bounds__(THREADS)
project_bwd_kernel(const float* __restrict__ means, const float* __restrict__ w2c,
                   const float* __restrict__ quats,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ logit_opacity,
                   const float* __restrict__ sh, Cam cam, int n, int sh_row,
                   int sh_vec, const float* __restrict__ g_mean2d,
                   const float* __restrict__ g_conic,
                   const float* __restrict__ g_rgbz,
                   const float* __restrict__ g_opacity, int gm_row, int gc_row,
                   int gr_row, int go_row, float* __restrict__ d_means,
                   float* __restrict__ d_quats, float* __restrict__ d_log_scales,
                   float* __restrict__ d_logit_opacity, float* __restrict__ d_sh,
                   float* __restrict__ pose_part) {
  __shared__ float red[POSE_TERMS][THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float dmc[3] = {0.0f, 0.0f, 0.0f};
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  if (i < n) {
    p0 = means[3 * i];
    p1 = means[3 * i + 1];
    p2 = means[3 * i + 2];
    const float4 q4 = __ldg(reinterpret_cast<const float4*>(quats) + i);
    const float q[4] = {q4.x, q4.y, q4.z, q4.w};
    const float ls[3] = {log_scales[3 * i], log_scales[3 * i + 1],
                         log_scales[3 * i + 2]};
    Geo g;
    geometry(w2c, p0, p1, p2, q, ls, cam, g);
    const float gpx = g_mean2d[(size_t)i * gm_row];
    const float gpy = g_mean2d[(size_t)i * gm_row + 1];
    const float gc0 = g_conic[(size_t)i * gc_row];
    const float gc1 = g_conic[(size_t)i * gc_row + 1];
    const float gc2 = g_conic[(size_t)i * gc_row + 2];
    const float gdepth = g_rgbz[(size_t)i * gr_row + 3];

    // pixel mean: px = (fx x) / zs + cx - 0.5
    float dx = gpx * cam.fx / g.zs;
    float dy = gpy * cam.fy / g.zs;
    const float dzs = -(gpx * (g.x * cam.fx) + gpy * (g.y * cam.fy)) / (g.zs * g.zs);
    float dz = fabsf(g.z) < 1e-8f ? 0.0f : dzs;
    dz += gdepth;

    // conic = (c, -b, a) / det
    float dca = gc2 / g.dsafe, dcc = gc0 / g.dsafe, dcb = -gc1 / g.dsafe;
    const float dds =
        -(gc0 * g.cc - gc1 * g.cb + gc2 * g.ca) / (g.dsafe * g.dsafe);
    const float ddet = g.det == 0.0f ? 0.0f : dds;
    dca += ddet * g.cc;
    dcc += ddet * g.ca;
    dcb -= 2.0f * g.cb * ddet;

    // cov2d = J Sigma J^T + 0.3 I: the Jacobian and Sigma's upper triangle
    const float da0 = dca * g.j00, da2 = dca * g.j02 + dcb * g.j12;
    const float da1 = dcb * g.j11, db1 = dcc * g.j11, db2 = dcc * g.j12;
    const float dj00 = dca * g.a0 + da0 * g.S00 + da1 * g.S01 + da2 * g.S02;
    const float dj02 = dca * g.a2 + da0 * g.S02 + da1 * g.S12 + da2 * g.S22;
    const float dj11 = dcb * g.a1 + dcc * g.b1 + db1 * g.S11 + db2 * g.S12;
    const float dj12 = dcb * g.a2 + dcc * g.b2 + db1 * g.S12 + db2 * g.S22;

    // J: j00 = fx / zp, j02 = -fx xc / zp^2, xc = clamp(x / zp) zp (and y)
    const float drz = dj00 * cam.fx + dj11 * cam.fy;
    const float dxc = dj02 / g.zz * -cam.fx, dyc = dj12 / g.zz * -cam.fy;
    const float dzz = -(dj02 * g.j02 + dj12 * g.j12) / g.zz;
    float dzp = 2.0f * g.zp * dzz - drz * g.rz * g.rz;
    dzp += dxc * g.tx + dyc * g.ty;
    const float dxr =
        (g.xr >= -cam.limx && g.xr <= cam.limx) ? dxc * g.zp : 0.0f;
    const float dyr =
        (g.yr >= -cam.limy && g.yr <= cam.limy) ? dyc * g.zp : 0.0f;
    dx += dxr / g.zp;
    dy += dyr / g.zp;
    dzp -= (dxr * g.x + dyr * g.y) / (g.zp * g.zp);
    dz += g.z == 0.0f ? 0.0f : dzp;
    dmc[0] = dx;
    dmc[1] = dy;
    dmc[2] = dz;

    if (GS) {
      // Sigma = M M^T, M = R diag(s): dM = (G + G^T) M
      const float dS00 = da0 * g.j00, dS01 = da1 * g.j00;
      const float dS02 = da0 * g.j02 + da2 * g.j00, dS11 = db1 * g.j11;
      const float dS12 = da1 * g.j02 + db1 * g.j12 + db2 * g.j11;
      const float dS22 = da2 * g.j02 + db2 * g.j12;
      const float Gs[9] = {2.0f * dS00, dS01, dS02, dS01, 2.0f * dS11,
                           dS12, dS02, dS12, 2.0f * dS22};
      float dR[9], dsc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float dm = 0.0f;
#pragma unroll
          for (int j = 0; j < 3; ++j) dm += Gs[3 * a + j] * (g.R[3 * j + k] * g.s[k]);
          dR[3 * a + k] = dm * g.s[k];
          dsc[k] += dm * g.R[3 * a + k];
        }
      d_log_scales[3 * i] = dsc[0] * g.s[0];
      d_log_scales[3 * i + 1] = dsc[1] * g.s[1];
      d_log_scales[3 * i + 2] = dsc[2] * g.s[2];

      // R(q / max(|q|, eps))
      const float w = g.qw, x = g.qx, y = g.qy, z = g.qz;
      const float dw = 2.0f * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5]
                               - y * dR[6] + x * dR[7]);
      const float dqx = 2.0f * (y * dR[1] + z * dR[2] + y * dR[3]
                                - 2.0f * x * dR[4] - w * dR[5] + z * dR[6]
                                + w * dR[7] - 2.0f * x * dR[8]);
      const float dqy = 2.0f * (-2.0f * y * dR[0] + x * dR[1] + w * dR[2]
                                + x * dR[3] + z * dR[5] - w * dR[6] + z * dR[7]
                                - 2.0f * y * dR[8]);
      const float dqz = 2.0f * (-2.0f * z * dR[0] - w * dR[1] + x * dR[2]
                                + w * dR[3] - 2.0f * z * dR[4] + y * dR[5]
                                + x * dR[6] + y * dR[7]);
      const float dqn[4] = {dw, dqx, dqy, dqz};
      const float dcn = -(dqn[0] * q[0] + dqn[1] * q[1] + dqn[2] * q[2]
                          + dqn[3] * q[3]) / (g.qc * g.qc);
      const float dnrm = g.qnorm >= 1e-12f ? dcn : 0.0f;
      const float kn = g.qnorm == 0.0f ? 0.0f : dnrm / g.qnorm;
      float4 dq4;
      dq4.x = dqn[0] / g.qc + q[0] * kn;
      dq4.y = dqn[1] / g.qc + q[1] * kn;
      dq4.z = dqn[2] / g.qc + q[2] * kn;
      dq4.w = dqn[3] / g.qc + q[3] * kn;
      reinterpret_cast<float4*>(d_quats)[i] = dq4;

      // opacity = sigmoid(logit)
      const float op = 1.0f / (1.0f + expf(-logit_opacity[i]));
      d_logit_opacity[i] = g_opacity[(size_t)i * go_row] * (1.0f - op) * op;

      // colour: rgb = max(sum_k b_k sh_k + 0.5, 0)
      constexpr int NK = NumCoeffs<DEG>::value;
      float c[3 * NK];
      load_sh<DEG>(sh + (size_t)i * sh_row, sh_vec, c);
      Dir d;
      view_dir(p0, p1, p2, d);
      float b[NK];
      sh_basis<DEG>(d, b);
      float dv[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v = sh_channel<DEG>(c, b, ch);
        const float gr = g_rgbz[(size_t)i * gr_row + ch];
        // torch.maximum's backward: half at a tie, all where v is NaN
        dv[ch] = v < 0.0f ? 0.0f : (v == 0.0f ? 0.5f * gr : gr);
      }
      float wk[NK];
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        wk[k] = c[3 * k] * dv[0] + c[3 * k + 1] * dv[1] + c[3 * k + 2] * dv[2];
        c[3 * k] = b[k] * dv[0];                 // c now holds d sh
        c[3 * k + 1] = b[k] * dv[1];
        c[3 * k + 2] = b[k] * dv[2];
      }
      float ddx, ddy, ddz;
      sh_basis_grad<DEG>(d, wk, ddx, ddy, ddz);
      // dirs = p r, r = rsqrt(max(n2, 1e-16)), n2 = |p|^2
      const float dr = ddx * p0 + ddy * p1 + ddz * p2;
      const float dn2c = -0.5f * dr * (d.r * d.r * d.r);
      const float dn2 = d.n2 >= 1e-16f ? dn2c : 0.0f;

      // means: R^T dmc + the view direction's share
      float dp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dp[k] = w2c[k] * dmc[0] + w2c[4 + k] * dmc[1] + w2c[8 + k] * dmc[2];
      dp[0] += ddx * d.r + 2.0f * p0 * dn2;
      dp[1] += ddy * d.r + 2.0f * p1 * dn2;
      dp[2] += ddz * d.r + 2.0f * p2 * dn2;
      d_means[3 * i] = dp[0];
      d_means[3 * i + 1] = dp[1];
      d_means[3 * i + 2] = dp[2];

      // d sh: the used coefficients, zero past them
      float* dst = d_sh + (size_t)i * sh_row;
      const int used = 3 * NK;
      if (sh_vec) {
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
        for (int v = 0; v < (3 * NK + 3) / 4; ++v) {
          float e[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) e[u] = 4 * v + u < used ? c[4 * v + u] : 0.0f;
          d4[v] = make_float4(e[0], e[1], e[2], e[3]);
        }
        for (int v = (3 * NK + 3) / 4; v < sh_row / 4; ++v)
          d4[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
#pragma unroll
        for (int u = 0; u < 3 * NK; ++u) dst[u] = c[u];
        for (int u = used; u < sh_row; ++u) dst[u] = 0.0f;
      }
    }
  }

  if (pose_part == nullptr) return;
  // d w2c[a][k] += dmc_a p_k, d w2c[a][3] += dmc_a: a fixed tree per block
  const float p[3] = {p0, p1, p2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) red[3 * a + k][threadIdx.x] = dmc[a] * p[k];
    red[9 + a][threadIdx.x] = dmc[a];
  }
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int t = 0; t < POSE_TERMS; ++t)
        red[t][threadIdx.x] += red[t][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < POSE_TERMS)
    pose_part[(size_t)blockIdx.x * POSE_TERMS + threadIdx.x] = red[threadIdx.x][0];
}

// The blocks' partials added in a fixed order into d w2c (4, 4).
__global__ void __launch_bounds__(THREADS)
project_pose_kernel(const float* __restrict__ pose_part, int blocks,
                    float* __restrict__ d_w2c) {
  __shared__ float red[POSE_TERMS][THREADS];
#pragma unroll
  for (int t = 0; t < POSE_TERMS; ++t) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < blocks; b += THREADS)
      acc += pose_part[(size_t)b * POSE_TERMS + t];
    red[t][threadIdx.x] = acc;
  }
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int t = 0; t < POSE_TERMS; ++t)
        red[t][threadIdx.x] += red[t][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < 16) {
    const int a = threadIdx.x / 4, k = threadIdx.x % 4;
    d_w2c[threadIdx.x] =
        a == 3 ? 0.0f : (k < 3 ? red[3 * a + k][0] : red[9 + a][0]);
  }
}

namespace {

Cam make_cam(float fx, float fy, float cx, float cy, float limx, float limy,
             float near_cull, int grid_x, int grid_y) {
  Cam c;
  c.fx = fx;
  c.fy = fy;
  c.cx = cx;
  c.cy = cy;
  c.limx = limx;
  c.limy = limy;
  c.near_cull = near_cull;
  c.grid_x = grid_x;
  c.grid_y = grid_y;
  return c;
}

template <int DEG>
void launch_fwd(const float* means, const float* w2c, const float* quats,
                const float* log_scales, const float* logit_opacity,
                const float* sh, const uint8_t* active, const float* probe,
                const Cam& cam, int n, int sh_row, int sh_vec, float* mean2d,
                float* conic, int* radius, int* tile_rect, int* tiles_touched,
                float* rgbz, float* opacity, cudaStream_t stream) {
  project_fwd_kernel<DEG><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      means, w2c, quats, log_scales, logit_opacity, sh, active, probe, cam, n,
      sh_row, sh_vec, mean2d, conic, radius, reinterpret_cast<int4*>(tile_rect),
      tiles_touched, reinterpret_cast<float4*>(rgbz), opacity);
}

template <int DEG, bool GS>
void launch_bwd(const float* means, const float* w2c, const float* quats,
                const float* log_scales, const float* logit_opacity,
                const float* sh, const Cam& cam, int n, int sh_row, int sh_vec,
                const float* g_mean2d, const float* g_conic,
                const float* g_rgbz, const float* g_opacity, int gm_row,
                int gc_row, int gr_row, int go_row, float* d_means,
                float* d_quats, float* d_log_scales, float* d_logit_opacity,
                float* d_sh, float* pose_part, cudaStream_t stream) {
  project_bwd_kernel<DEG, GS><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      means, w2c, quats, log_scales, logit_opacity, sh, cam, n, sh_row, sh_vec,
      g_mean2d, g_conic, g_rgbz, g_opacity, gm_row, gc_row, gr_row,
      go_row, d_means, d_quats, d_log_scales, d_logit_opacity, d_sh, pose_part);
}

}  // namespace

// Forward: everything _raster_inputs returns. Pointers first, then n, the
// SH row length in floats (3K), whether rows move in 16-byte pieces, the SH
// degree, the tile grid, then the camera's floats and the stream.
extern "C" int project_fwd(const float* means, const float* quats,
                           const float* log_scales, const float* logit_opacity,
                           const float* sh, const float* w2c,
                           const uint8_t* active, const float* probe,
                           float* mean2d, float* conic, int* radius,
                           int* tile_rect, int* tiles_touched, float* rgbz,
                           float* opacity, int n, int sh_row, int sh_vec,
                           int degree, int grid_x, int grid_y, float fx,
                           float fy, float cx, float cy, float limx, float limy,
                           float near_cull, void* stream) {
  if (n > 0) {
    const Cam cam = make_cam(fx, fy, cx, cy, limx, limy, near_cull, grid_x, grid_y);
    cudaStream_t s = (cudaStream_t)stream;
#define FWD(D)                                                                 \
  launch_fwd<D>(means, w2c, quats, log_scales, logit_opacity, sh, active,      \
                probe, cam, n, sh_row, sh_vec, mean2d, conic, radius,          \
                tile_rect, tiles_touched, rgbz, opacity, s)
    switch (degree) {
      case 0: FWD(0); break;
      case 1: FWD(1); break;
      case 2: FWD(2); break;
      case 3: FWD(3); break;
      case 4: FWD(4); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef FWD
  }
  return (int)cudaGetLastError();
}

// Backward: the Gaussians' gradients (d_means non-null) and / or the pose's
// (d_w2c non-null; pose_part holds ceil(n / 256) x 12 floats of scratch).
extern "C" int project_bwd(const float* means, const float* quats,
                           const float* log_scales, const float* logit_opacity,
                           const float* sh, const float* w2c,
                           const float* g_mean2d, const float* g_conic,
                           const float* g_rgbz, const float* g_opacity,
                           float* d_means, float* d_quats, float* d_log_scales,
                           float* d_logit_opacity, float* d_sh, float* pose_part,
                           float* d_w2c, int n, int sh_row, int sh_vec,
                           int degree, int gm_row, int gc_row,
                           int gr_row, int go_row, int grid_x, int grid_y,
                           float fx, float fy, float cx, float cy, float limx,
                           float limy, float near_cull, void* stream) {
  const bool gs = d_means != nullptr;
  float* part = d_w2c != nullptr ? pose_part : nullptr;
  if (n > 0 && (gs || part != nullptr)) {
    const Cam cam = make_cam(fx, fy, cx, cy, limx, limy, near_cull, grid_x, grid_y);
    cudaStream_t s = (cudaStream_t)stream;
#define BWD(D, G)                                                              \
  launch_bwd<D, G>(means, w2c, quats, log_scales, logit_opacity, sh, cam, n,   \
                   sh_row, sh_vec, g_mean2d, g_conic, g_rgbz,                  \
                   g_opacity, gm_row, gc_row, gr_row, go_row, d_means,         \
                   d_quats, d_log_scales, d_logit_opacity, d_sh, part, s)
    if (gs) {
      switch (degree) {
        case 0: BWD(0, true); break;
        case 1: BWD(1, true); break;
        case 2: BWD(2, true); break;
        case 3: BWD(3, true); break;
        case 4: BWD(4, true); break;
        default: return (int)cudaErrorInvalidValue;
      }
    } else {
      BWD(0, false);            // the pose alone reads no SH
    }
#undef BWD
    if (part != nullptr) {
      project_pose_kernel<<<1, THREADS, 0, s>>>(
          part, (n + THREADS - 1) / THREADS, d_w2c);
    }
  } else if (d_w2c != nullptr) {
    cudaMemsetAsync(d_w2c, 0, 16 * sizeof(float), (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
