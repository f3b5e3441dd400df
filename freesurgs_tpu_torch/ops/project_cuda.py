"""The per-Gaussian projection, forward and backward: one CUDA kernel each
for Hopper, plus their plain PyTorch versions.

Everything ``ops/render.py`` hands the rasterizer comes from here: the
world->camera transform, the EWA projection with its cull and 16 px tile
rect (``ops/projection.py``), the opacity and SH -> RGB against the origin
(``core/sh.py``), with the densify probe added to the projected means.
``raster_inputs`` returns (ProjectedGaussians, rgbz (N, 4), opacity (N,))
through ``Project``, an autograd Function:

- on a CUDA tensor its forward is one launch of ``csrc/project.cu``'s
  forward kernel and its backward one launch of the backward kernel (plus,
  when the pose needs a gradient, one small fixed-order reduction); each
  launch is counted in ``raster_cuda.LAUNCHES`` ("project_fwd",
  "project_bwd", "project_pose"; no Gaussians, no launch);
- on a CPU tensor its forward is ``raster_inputs_plain``, the port's
  projection written op by op (bit for bit what it always was), and its
  backward ``project_bwd_plain``, the kernel's backward written in PyTorch
  line by line: the gradients autograd gives through the plain forward,
  derived by hand.

There is no fallback between the two. The kernels replace no TPU kernel
(XLA fuses the JAX chain); their source note says what bounds them.

The backward keeps the plain forward's autograd semantics at every edge:
``torch.maximum(v, 0)`` splits the gradient 0.5 / 0.5 at a tie, ``clamp``
and ``clamp_min`` pass it on their inclusive side, the EWA clamp of x/z,
y/z at 1.3 tan(fov) cuts the Jacobian's gradient to x and y, ``det == 0``
and ``z == 0`` take their constant branches, the view direction's
``rsqrt(max(|p|^2, 1e-16))`` keeps unused zero means finite, and nothing
flows through radius or the visibility. The probe's gradient is the
gradient of mean2d. ``gs`` (any Gaussian input needs a gradient) and the
pose (``w2c`` needs one) are computed only when asked.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..core.camera import Camera
from ..core.sh import C1, C2, C3, C4, eval_sh, num_sh_coeffs, \
    sh_to_rgb_clamped
from ..core.transforms import quat_to_rotmat, transform_points
from .projection import TILE, ProjectedGaussians, build_cov3d, \
    project_gaussians
from .raster_cuda import LAUNCHES, kernel_fn

THREADS = 256          # the kernels' block size (csrc/project.cu)
POSE_TERMS = 12        # per-block partials of the pose gradient


def raster_inputs_plain(means_w, quats, log_scales, logit_opacity,
                        sh_coeffs, w2c, cam: Camera, active, probe2d,
                        sh_degree: int):
    """The projection op by op, differentiable by autograd: (proj, rgbz
    (N, 4), opacity)."""
    mean_cam = transform_points(w2c, means_w)
    opacity = torch.sigmoid(logit_opacity)
    proj = project_gaussians(mean_cam, torch.exp(log_scales), quats, cam,
                             active=active)
    if probe2d is not None:
        proj = proj._replace(mean2d=proj.mean2d + probe2d)

    # SH -> RGB against the origin; rsqrt(max(|x|^2, eps^2)) keeps the
    # gradient of exactly-zero (unused) means at 0 instead of 0 * inf.
    n2 = torch.sum(means_w * means_w, dim=-1, keepdim=True)
    dirs = means_w * torch.rsqrt(torch.clamp_min(n2, 1e-16))
    rgb = sh_to_rgb_clamped(sh_degree, sh_coeffs, dirs)
    return proj, torch.cat([rgb, proj.depth[:, None]], dim=1), opacity


# ------------------------------------------------------ the plain backward

def _geometry(means, quats, log_scales, w2c, cam: Camera):
    """The projection's intermediates, each (N,), recomputed by the plain
    forward's own ops (so every branch test sees the forward's values)."""
    g = SimpleNamespace()
    g.x, g.y, g.z = transform_points(w2c, means).unbind(1)
    g.qnorm = torch.linalg.norm(quats, dim=-1)
    g.qc = torch.clamp_min(g.qnorm, 1e-12)
    g.qn = (quats / g.qc[:, None]).unbind(1)
    g.R = quat_to_rotmat(quats).reshape(-1, 9).unbind(1)
    g.s = torch.exp(log_scales).unbind(1)
    S = build_cov3d(torch.exp(log_scales), quats)
    g.S00, g.S01, g.S02 = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    g.S11, g.S12, g.S22 = S[:, 1, 1], S[:, 1, 2], S[:, 2, 2]

    # ewa_cov2d
    g.zp = torch.where(g.z == 0, torch.full_like(g.z, 1e-6), g.z)
    limx = 1.3 * cam.tan_fov_x
    limy = 1.3 * cam.tan_fov_y
    g.xr = g.x / g.zp
    g.yr = g.y / g.zp
    g.tx = torch.clamp(g.xr, -limx, limx)
    g.ty = torch.clamp(g.yr, -limy, limy)
    xc, yc = g.tx * g.zp, g.ty * g.zp
    g.rz = g.zp.reciprocal()
    g.zz = g.zp * g.zp
    g.j00 = g.rz * cam.fx
    g.j02 = -cam.fx * xc / g.zz
    g.j11 = g.rz * cam.fy
    g.j12 = -cam.fy * yc / g.zz
    g.a0 = g.j00 * g.S00 + g.j02 * g.S02
    g.a1 = g.j00 * g.S01 + g.j02 * g.S12
    g.a2 = g.j00 * g.S02 + g.j02 * g.S22
    g.b1 = g.j11 * g.S11 + g.j12 * g.S12
    g.b2 = g.j11 * g.S12 + g.j12 * g.S22
    g.ca = g.a0 * g.j00 + g.a2 * g.j02 + 0.3
    g.cb = g.a1 * g.j11 + g.a2 * g.j12
    g.cc = g.b1 * g.j11 + g.b2 * g.j12 + 0.3

    # project_gaussians
    g.zs = torch.where(g.z.abs() < 1e-8, torch.full_like(g.z, 1e-8), g.z)
    g.det = g.ca * g.cc - g.cb * g.cb
    g.dsafe = torch.where(g.det == 0, torch.ones_like(g.det), g.det)
    return g


def _sh_basis_grad(degree: int, x, y, z, w):
    """(sum_k w_k db_k/dx, .../dy, .../dz) of ``eval_sh``'s basis b_k at the
    direction (x, y, z); w: the coefficients' weights, one (N,) each."""
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(x)
    gz = torch.zeros_like(x)
    if degree > 0:
        gx = gx - C1 * w[3]
        gy = gy - C1 * w[1]
        gz = gz + C1 * w[2]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + (C2[0] * y * w[4] - 2 * C2[2] * x * w[6] + C2[3] * z * w[7]
                   + 2 * C2[4] * x * w[8])
        gy = gy + (C2[0] * x * w[4] + C2[1] * z * w[5] - 2 * C2[2] * y * w[6]
                   - 2 * C2[4] * y * w[8])
        gz = gz + C2[1] * y * w[5] + 4 * C2[2] * z * w[6] + C2[3] * x * w[7]
        if degree > 2:
            gx = gx + (6 * C3[0] * x * y * w[9] + C3[1] * y * z * w[10]
                       - 2 * C3[2] * x * y * w[11] - 6 * C3[3] * x * z * w[12]
                       + C3[4] * (4 * zz - 3 * xx - yy) * w[13]
                       + 2 * C3[5] * x * z * w[14]
                       + 3 * C3[6] * (xx - yy) * w[15])
            gy = gy + (3 * C3[0] * (xx - yy) * w[9] + C3[1] * x * z * w[10]
                       + C3[2] * (4 * zz - xx - 3 * yy) * w[11]
                       - 6 * C3[3] * y * z * w[12] - 2 * C3[4] * x * y * w[13]
                       - 2 * C3[5] * y * z * w[14] - 6 * C3[6] * x * y * w[15])
            gz = gz + (C3[1] * x * y * w[10] + 8 * C3[2] * y * z * w[11]
                       + C3[3] * (6 * zz - 3 * xx - 3 * yy) * w[12]
                       + 8 * C3[4] * x * z * w[13] + C3[5] * (xx - yy) * w[14])
        if degree > 3:
            gx = gx + (C4[0] * y * (3 * xx - yy) * w[16]
                       + 6 * C4[1] * x * y * z * w[17]
                       + C4[2] * y * (7 * zz - 1) * w[18]
                       + C4[5] * z * (7 * zz - 3) * w[21]
                       + 2 * C4[6] * x * (7 * zz - 1) * w[22]
                       + 3 * C4[7] * z * (xx - yy) * w[23]
                       + 4 * C4[8] * x * (xx - 3 * yy) * w[24])
            gy = gy + (C4[0] * x * (xx - 3 * yy) * w[16]
                       + 3 * C4[1] * z * (xx - yy) * w[17]
                       + C4[2] * x * (7 * zz - 1) * w[18]
                       + C4[3] * z * (7 * zz - 3) * w[19]
                       - 2 * C4[6] * y * (7 * zz - 1) * w[22]
                       - 6 * C4[7] * x * y * z * w[23]
                       + 4 * C4[8] * y * (yy - 3 * xx) * w[24])
            gz = gz + (C4[1] * y * (3 * xx - yy) * w[17]
                       + 14 * C4[2] * x * y * z * w[18]
                       + C4[3] * y * (21 * zz - 3) * w[19]
                       + C4[4] * z * (140 * zz - 60) * w[20]
                       + C4[5] * x * (21 * zz - 3) * w[21]
                       + 14 * C4[6] * z * (xx - yy) * w[22]
                       + C4[7] * x * (xx - 3 * yy) * w[23])
    return gx, gy, gz


def _sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(N, (degree + 1)^2) basis values: ``eval_sh`` of a one-hot row."""
    k = num_sh_coeffs(degree)
    eye = torch.eye(k, dtype=dirs.dtype, device=dirs.device)
    return eval_sh(degree, eye.expand(dirs.shape[0], k, k), dirs)


def project_bwd_plain(means, quats, log_scales, logit_opacity, sh, w2c,
                      cam: Camera, sh_degree: int, g_mean2d, g_conic, g_rgbz,
                      g_opacity, gs: bool = True, pose: bool = True):
    """The backward of ``raster_inputs_plain`` (cotangents of mean2d (N, 2),
    conic (N, 3), rgbz (N, 4), opacity (N,)), derived by hand, in the
    order of ``csrc/project.cu``'s backward kernel. Returns (d means,
    d quats, d log_scales, d logit_opacity, d sh, d w2c), the Gaussians'
    None unless ``gs``, d w2c None unless ``pose``."""
    g = _geometry(means, quats, log_scales, w2c, cam)
    gpx, gpy = g_mean2d.unbind(1)
    gc0, gc1, gc2 = g_conic.unbind(1)
    zero = torch.zeros_like(g.z)

    # pixel mean: px = (fx x) / zs + cx - 0.5
    dx = gpx * cam.fx / g.zs
    dy = gpy * cam.fy / g.zs
    dzs = -(gpx * (g.x * cam.fx) + gpy * (g.y * cam.fy)) / (g.zs * g.zs)
    dz = torch.where(g.z.abs() < 1e-8, zero, dzs)
    dz = dz + g_rgbz[:, 3]

    # conic = (c, -b, a) / det
    dca = gc2 / g.dsafe
    dcc = gc0 / g.dsafe
    dcb = -gc1 / g.dsafe
    dds = -(gc0 * g.cc - gc1 * g.cb + gc2 * g.ca) / (g.dsafe * g.dsafe)
    ddet = torch.where(g.det == 0, zero, dds)
    dca = dca + ddet * g.cc
    dcc = dcc + ddet * g.ca
    dcb = dcb - 2 * g.cb * ddet

    # cov2d = J Sigma J^T + 0.3 I: the Jacobian and Sigma's upper triangle
    da0, da2 = dca * g.j00, dca * g.j02 + dcb * g.j12
    da1, db1, db2 = dcb * g.j11, dcc * g.j11, dcc * g.j12
    dj00 = dca * g.a0 + da0 * g.S00 + da1 * g.S01 + da2 * g.S02
    dj02 = dca * g.a2 + da0 * g.S02 + da1 * g.S12 + da2 * g.S22
    dj11 = dcb * g.a1 + dcc * g.b1 + db1 * g.S11 + db2 * g.S12
    dj12 = dcb * g.a2 + dcc * g.b2 + db1 * g.S12 + db2 * g.S22

    # J: j00 = fx / zp, j02 = -fx xc / zp^2, xc = clamp(x / zp) zp (and y)
    limx = 1.3 * cam.tan_fov_x
    limy = 1.3 * cam.tan_fov_y
    drz = dj00 * cam.fx + dj11 * cam.fy
    dxc = dj02 / g.zz * -cam.fx
    dyc = dj12 / g.zz * -cam.fy
    dzz = -(dj02 * g.j02 + dj12 * g.j12) / g.zz
    dzp = 2 * g.zp * dzz - drz * g.rz * g.rz
    dzp = dzp + dxc * g.tx + dyc * g.ty
    dxr = torch.where((g.xr >= -limx) & (g.xr <= limx), dxc * g.zp, zero)
    dyr = torch.where((g.yr >= -limy) & (g.yr <= limy), dyc * g.zp, zero)
    dx = dx + dxr / g.zp
    dy = dy + dyr / g.zp
    dzp = dzp - (dxr * g.x + dyr * g.y) / (g.zp * g.zp)
    dz = dz + torch.where(g.z == 0, zero, dzp)
    dmc = torch.stack([dx, dy, dz], dim=1)

    d_w2c = None
    if pose:
        d_w2c = torch.zeros_like(w2c)
        d_w2c[:3, :3] = dmc.T @ means
        d_w2c[:3, 3] = dmc.sum(0)
    if not gs:
        return None, None, None, None, None, d_w2c

    # Sigma = M M^T, M = R diag(s): dM = (G + G^T) M
    dS00, dS01 = da0 * g.j00, da1 * g.j00
    dS02, dS11 = da0 * g.j02 + da2 * g.j00, db1 * g.j11
    dS12 = da1 * g.j02 + db1 * g.j12 + db2 * g.j11
    dS22 = da2 * g.j02 + db2 * g.j12
    Gs = (2 * dS00, dS01, dS02, dS01, 2 * dS11, dS12, dS02, dS12, 2 * dS22)
    dR = [None] * 9
    dsc = [zero, zero, zero]
    for a in range(3):
        for k in range(3):
            dm = (Gs[3 * a] * (g.R[k] * g.s[k])
                  + Gs[3 * a + 1] * (g.R[3 + k] * g.s[k])
                  + Gs[3 * a + 2] * (g.R[6 + k] * g.s[k]))
            dR[3 * a + k] = dm * g.s[k]
            dsc[k] = dsc[k] + dm * g.R[3 * a + k]
    d_log_scales = torch.stack([dsc[k] * g.s[k] for k in range(3)], dim=1)

    # R(q / max(|q|, eps))
    w, x, y, z = g.qn
    dqn = (2 * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] - y * dR[6]
                + x * dR[7]),
           2 * (y * dR[1] + z * dR[2] + y * dR[3] - 2 * x * dR[4] - w * dR[5]
                + z * dR[6] + w * dR[7] - 2 * x * dR[8]),
           2 * (-2 * y * dR[0] + x * dR[1] + w * dR[2] + x * dR[3] + z * dR[5]
                - w * dR[6] + z * dR[7] - 2 * y * dR[8]),
           2 * (-2 * z * dR[0] - w * dR[1] + x * dR[2] + w * dR[3]
                - 2 * z * dR[4] + y * dR[5] + x * dR[6] + y * dR[7]))
    q = quats.unbind(1)
    dcn = -(dqn[0] * q[0] + dqn[1] * q[1] + dqn[2] * q[2]
            + dqn[3] * q[3]) / (g.qc * g.qc)
    dnrm = torch.where(g.qnorm >= 1e-12, dcn, zero)
    kn = torch.where(g.qnorm == 0, zero, dnrm / g.qnorm)
    d_quats = torch.stack([dqn[i] / g.qc + q[i] * kn for i in range(4)],
                          dim=1)

    # opacity = sigmoid(logit)
    op = torch.sigmoid(logit_opacity)
    d_logit_opacity = g_opacity * (1 - op) * op

    # colour: rgb = max(sum_k b_k sh_k + 0.5, 0)
    p0, p1, p2 = means.unbind(1)
    n2 = torch.sum(means * means, dim=-1)
    r = torch.rsqrt(torch.clamp_min(n2, 1e-16))
    dirs = means * r[:, None]
    nk = num_sh_coeffs(sh_degree)
    v = eval_sh(sh_degree, sh, dirs) + 0.5
    gr = g_rgbz[:, 0:3]
    # torch.maximum's backward: half at a tie, all where v is NaN
    dv = torch.where(v < 0, torch.zeros_like(gr),
                     torch.where(v == 0, 0.5 * gr, gr))
    b = _sh_basis(sh_degree, dirs)                          # (N, nk)
    wk = (sh[:, :nk] * dv[:, None, :]).sum(-1).unbind(1)    # nk of (N,)
    d_sh = torch.zeros_like(sh)
    d_sh[:, :nk] = b[:, :, None] * dv[:, None, :]
    ddx, ddy, ddz = _sh_basis_grad(sh_degree, *dirs.unbind(1), wk)
    # dirs = p r, r = rsqrt(max(n2, 1e-16)), n2 = |p|^2
    dr = ddx * p0 + ddy * p1 + ddz * p2
    dn2c = -0.5 * dr * (r * r * r)
    dn2 = torch.where(n2 >= 1e-16, dn2c, zero)

    # means: R^T dmc + the view direction's share
    d_means = dmc @ w2c[:3, :3]
    d_means = d_means + torch.stack([ddx, ddy, ddz], 1) * r[:, None] \
        + 2 * means * dn2[:, None]
    return d_means, d_quats, d_log_scales, d_logit_opacity, d_sh, d_w2c


# ------------------------------------------------------- kernel launches

def _cam_args(cam: Camera):
    """The kernels' camera ints and floats: the tile grid, then fx, fy, cx,
    cy, the EWA clamp 1.3 tan(fov) and the near cull (each rounded to f32
    by ctypes, as PyTorch rounds a Python scalar)."""
    return ((-(-cam.width // TILE), -(-cam.height // TILE)),
            (cam.fx, cam.fy, cam.cx, cam.cy, 1.3 * cam.tan_fov_x,
             1.3 * cam.tan_fov_y, cam.near_cull))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _operand(t: torch.Tensor, name: str, shape, dev, dtype=torch.float32,
             align: int = 4) -> torch.Tensor:
    """``t`` checked, and copied when it is not contiguous or not aligned to
    ``align`` bytes (a fresh allocation is)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _inputs(means, quats, log_scales, logit_opacity, sh, w2c, sh_degree):
    dev = means.device
    n, k = means.shape[0], sh.shape[1]
    if k < num_sh_coeffs(sh_degree) or not 0 <= sh_degree <= 4:
        raise ValueError(f"sh_degree {sh_degree} with {k} SH coefficients")
    if n >= 2 ** 31 // (3 * k):
        raise ValueError(f"too many Gaussians for int32 offsets: {n}")
    ins = (_operand(means, "means", (n, 3), dev),
           _operand(quats, "quats", (n, 4), dev, align=16),
           _operand(log_scales, "log_scales", (n, 3), dev),
           _operand(logit_opacity, "logit_opacity", (n,), dev),
           _operand(sh, "sh", (n, k, 3), dev),
           _operand(w2c, "w2c", (4, 4), dev))
    # SH rows move in 16-byte pieces where their length and base allow
    vec = int(3 * k % 4 == 0 and ins[4].data_ptr() % 16 == 0)
    return dev, n, k, vec, ins


def project_fwd(means, quats, log_scales, logit_opacity, sh, w2c,
                cam: Camera, active, probe2d, sh_degree: int):
    """The forward kernel on CUDA tensors: (mean2d, conic, rgbz, opacity,
    radius, tile_rect, tiles_touched), ``raster_inputs_plain``'s."""
    dev, n, k, vec, ins = _inputs(means, quats, log_scales, logit_opacity,
                                  sh, w2c, sh_degree)
    if active is not None:
        active = _operand(active, "active", (n,), dev, torch.bool, 1)
    if probe2d is not None:
        probe2d = _operand(probe2d, "probe2d", (n, 2), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    mean2d, conic = torch.empty(n, 2, **f32), torch.empty(n, 3, **f32)
    rgbz, opacity = torch.empty(n, 4, **f32), torch.empty(n, **f32)
    radius, rect = torch.empty(n, **i32), torch.empty(n, 4, **i32)
    tiles = torch.empty(n, **i32)
    grid, floats = _cam_args(cam)
    fn = kernel_fn("project", "project_fwd", 15, n_int=6, n_float=7)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*map(_ptr, ins), _ptr(active), _ptr(probe2d),
                 *map(_ptr, (mean2d, conic, radius, rect, tiles, rgbz,
                             opacity)),
                 n, 3 * k, vec, sh_degree, *grid, *floats, stream)
    if err != 0:
        raise RuntimeError(f"project_fwd launch failed: CUDA error {err}")
    LAUNCHES["project_fwd"] += int(n > 0)
    return mean2d, conic, rgbz, opacity, radius, rect, tiles


def _cotangent(g: torch.Tensor, name: str, shape, dev):
    """A cotangent as the kernel reads it: float32, its last dim unit
    stride, rows ``g.stride(0)`` floats apart (strided views pass)."""
    if g.device != dev or g.dtype != torch.float32 \
            or tuple(g.shape) != tuple(shape):
        raise ValueError(f"cotangent {name}: {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    if g.dim() > 1 and g.stride(-1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


def project_bwd(means, quats, log_scales, logit_opacity, sh, w2c,
                cam: Camera, sh_degree: int, g_mean2d, g_conic, g_rgbz,
                g_opacity, gs: bool = True, pose: bool = True):
    """The backward kernel on CUDA tensors: ``project_bwd_plain``'s
    gradients. One launch, and with ``pose`` a second, the fixed-order
    reduction of the blocks' partials into d w2c (with no Gaussians, only
    a memset of d w2c)."""
    dev, n, k, vec, ins = _inputs(means, quats, log_scales, logit_opacity,
                                  sh, w2c, sh_degree)
    gm, gm_row = _cotangent(g_mean2d, "mean2d", (n, 2), dev)
    gc, gc_row = _cotangent(g_conic, "conic", (n, 3), dev)
    gr, gr_row = _cotangent(g_rgbz, "rgbz", (n, 4), dev)
    go, go_row = _cotangent(g_opacity, "opacity", (n,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = ((torch.empty(n, 3, **f32), torch.empty(n, 4, **f32),
             torch.empty(n, 3, **f32), torch.empty(n, **f32),
             torch.empty(n, k, 3, **f32)) if gs else (None,) * 5)
    part = d_w2c = None
    if pose:
        part = torch.empty(-(-n // THREADS) * POSE_TERMS, **f32)
        d_w2c = torch.empty(4, 4, **f32)
    grid, floats = _cam_args(cam)
    fn = kernel_fn("project", "project_bwd", 17, n_int=10, n_float=7)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*map(_ptr, ins), *map(_ptr, (gm, gc, gr, go)),
                 *map(_ptr, outs), _ptr(part), _ptr(d_w2c),
                 n, 3 * k, vec, sh_degree, gm_row, gc_row, gr_row, go_row,
                 *grid, *floats, stream)
    if err != 0:
        raise RuntimeError(f"project_bwd launch failed: CUDA error {err}")
    LAUNCHES["project_bwd"] += int(n > 0 and (gs or pose))
    LAUNCHES["project_pose"] += int(n > 0 and pose)
    return (*outs, d_w2c)


class Project(torch.autograd.Function):
    """Everything ``_raster_inputs`` returns, differentiable in the
    Gaussians, the pose and the probe: (mean2d, conic, rgbz, opacity,
    radius, tile_rect, tiles_touched); the last three carry no gradient."""

    @staticmethod
    def forward(ctx, means, quats, log_scales, logit_opacity, sh, w2c,
                probe2d, active, cam, sh_degree):
        if means.is_cuda:
            out = project_fwd(means, quats, log_scales, logit_opacity, sh,
                              w2c, cam, active, probe2d, sh_degree)
        else:
            proj, rgbz, opacity = raster_inputs_plain(
                means, quats, log_scales, logit_opacity, sh, w2c, cam,
                active, probe2d, sh_degree)
            out = (proj.mean2d, proj.conic, rgbz, opacity, proj.radius,
                   proj.tile_rect, proj.tiles_touched)
        ctx.mark_non_differentiable(*out[4:])
        ctx.save_for_backward(means, quats, log_scales, logit_opacity, sh,
                              w2c)
        ctx.cam = cam
        ctx.sh_degree = sh_degree
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_rgbz, g_opacity, *_):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        gs, pose = any(need[:5]), need[5]
        grads = (None,) * 6
        if gs or pose:
            bwd = project_bwd if saved[0].is_cuda else project_bwd_plain
            grads = bwd(*saved, ctx.cam, ctx.sh_degree, g_mean2d, g_conic,
                        g_rgbz, g_opacity, gs=gs, pose=pose)
        return (*(d if want else None for d, want in zip(grads, need)),
                g_mean2d if need[6] else None, None, None, None)


def raster_inputs(means_w, quats, log_scales, logit_opacity, sh_coeffs, w2c,
                  cam: Camera, active, probe2d, sh_degree: int):
    """The projection for ``rasterize``: (proj, rgbz (N, 4), opacity (N,)),
    through ``Project`` (one kernel each way on a CUDA tensor)."""
    mean2d, conic, rgbz, opacity, radius, rect, tiles = Project.apply(
        means_w, quats, log_scales, logit_opacity, sh_coeffs, w2c, probe2d,
        active, cam, sh_degree)
    proj = ProjectedGaussians(mean2d=mean2d, conic=conic, depth=rgbz[:, 3],
                              radius=radius, tile_rect=rect,
                              tiles_touched=tiles)
    return proj, rgbz, opacity
