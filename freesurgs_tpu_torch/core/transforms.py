"""Quaternion / SE(3) utilities (port of ``freesurgs_tpu/core/transforms.py``).

Quaternions are (w, x, y, z), stored unnormalized and normalized before
use. Everything is differentiable with ``torch.autograd``.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(norm, eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion(s) -> (..., 3, 3) rotation(s); normalizes inside,
    so gradients flow through the normalization."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    rows = [torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1)]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation(s) -> (..., 4) unit quaternion(s) with w >= 0.

    Branch-free Shepperd: four candidate constructions, the best-conditioned
    (largest diagonal term) picked per element."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp_min(qw, 1e-12)) * 0.5
    d = 4.0 * qw
    c0 = torch.stack([qw[..., 0], (m21 - m12) / d[..., 0],
                      (m02 - m20) / d[..., 0], (m10 - m01) / d[..., 0]], -1)
    c1 = torch.stack([(m21 - m12) / d[..., 1], qw[..., 1],
                      (m01 + m10) / d[..., 1], (m02 + m20) / d[..., 1]], -1)
    c2 = torch.stack([(m02 - m20) / d[..., 2], (m01 + m10) / d[..., 2],
                      qw[..., 2], (m12 + m21) / d[..., 2]], -1)
    c3 = torch.stack([(m10 - m01) / d[..., 3], (m02 + m20) / d[..., 3],
                      (m12 + m21) / d[..., 3], qw[..., 3]], -1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)          # (..., 4, 4)
    best = torch.argmax(qw, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., :1] < 0, -q, q)


def build_w2c(quat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 world->camera from (..., 4) quat and (..., 3) translation."""
    R = quat_to_rotmat(quat)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (N, 3) points; differentiable in both, the
    route of SE(3) pose gradients around the rasterizer."""
    return pts @ T[:3, :3].T + T[:3, 3]


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., :, None])[..., 0]
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype,
                          device=T.device).expand(T.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    rows = [torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)]
    return torch.stack(rows, dim=-2)


def relative_pose(w2c_1: torch.Tensor, w2c_2: torch.Tensor):
    """(R, t) mapping camera-1 coordinates to camera-2 coordinates."""
    R1, t1 = w2c_1[:3, :3], w2c_1[:3, 3]
    R2, t2 = w2c_2[:3, :3], w2c_2[:3, 3]
    R_rel = R2 @ R1.T
    t_rel = t2 - R_rel @ t1
    return R_rel, t_rel


def essential_from_poses(w2c_1: torch.Tensor,
                         w2c_2: torch.Tensor) -> torch.Tensor:
    """E = [t_rel]x R_rel, so that x2^T E x1 = 0 in normalized coords."""
    R_rel, t_rel = relative_pose(w2c_1, w2c_2)
    return skew(t_rel) @ R_rel


def fundamental_from_essential(E: torch.Tensor, K1: torch.Tensor,
                               K2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(K2).T @ E @ torch.linalg.inv(K1)


def euler_degrees_to_rotmat(euler_xyz_deg: torch.Tensor) -> torch.Tensor:
    """XYZ-intrinsic Euler angles in degrees (3,) -> 3x3 rotation Rz Ry Rx
    (reference ``utils/geometry_utils.py:92-138``; the viewer path)."""
    cx, cy, cz = torch.cos(torch.deg2rad(euler_xyz_deg)).unbind()
    sx, sy, sz = torch.sin(torch.deg2rad(euler_xyz_deg)).unbind()
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).view(3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).view(3, 3)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).view(3, 3)
    return rz @ ry @ rx
