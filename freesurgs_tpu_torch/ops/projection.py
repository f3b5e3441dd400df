"""Per-Gaussian projection stage: cull, EWA splat, tile extent
(port of ``freesurgs_tpu/ops/projection.py``).

Parity constants with the CUDA ``preprocess`` kernel: +0.3 dilation of
cov2D, ceil(3 sqrt(lambda_max)) radius, near cull at z <= 0.2, pixel map
``pix = f x/z + c - 0.5``, EWA Jacobian at x/z clamped to 1.3 tan(fov).
Like the reference, covariances are NOT rotated into the camera frame
(only means are); ``w2c_rot`` gives the geometrically-correct variant.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.camera import Camera
from ..core.transforms import quat_to_rotmat

TILE = 16  # pixels per tile side (the CUDA binning granularity)


class ProjectedGaussians(NamedTuple):
    """Projection output; every tensor has leading dim N (the capacity)."""

    mean2d: torch.Tensor      # (N, 2) pixel coords
    conic: torch.Tensor       # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor       # (N,)  camera-frame z
    radius: torch.Tensor      # (N,)  int32 screen radius in px (0 = culled)
    tile_rect: torch.Tensor   # (N, 4) int32 (tx0, ty0, tx1, ty1), half-open
    tiles_touched: torch.Tensor  # (N,) int32


def to_int32(x: torch.Tensor, big: float = 1e9) -> torch.Tensor:
    """Float -> int32 truncation, made total: NaN -> 0 and values clipped to
    +/-1e9 first, as XLA's saturating convert behaves (a bare torch cast of
    an out-of-range float is undefined)."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-big, big)
    return x.to(torch.int32)


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T, full 3x3."""
    R = quat_to_rotmat(quats)
    M = R * scales[:, None, :]
    return M @ M.transpose(-1, -2)


def ewa_cov2d(mean_cam: torch.Tensor, cov3d: torch.Tensor, cam: Camera,
              w2c_rot: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 3) packed symmetric 2D covariance (a, b, c) with +0.3 dilation."""
    x, y, z = mean_cam[:, 0], mean_cam[:, 1], mean_cam[:, 2]
    z = torch.where(z == 0, torch.full_like(z, 1e-6), z)
    limx = 1.3 * cam.tan_fov_x
    limy = 1.3 * cam.tan_fov_y
    txtz = torch.clamp(x / z, -limx, limx)
    tytz = torch.clamp(y / z, -limy, limy)
    xc = txtz * z
    yc = tytz * z

    j00 = cam.fx / z
    j02 = -cam.fx * xc / (z * z)
    j11 = cam.fy / z
    j12 = -cam.fy * yc / (z * z)

    if w2c_rot is not None:
        cov3d = w2c_rot @ cov3d @ w2c_rot.T

    s00, s01, s02 = cov3d[:, 0, 0], cov3d[:, 0, 1], cov3d[:, 0, 2]
    s11, s12, s22 = cov3d[:, 1, 1], cov3d[:, 1, 2], cov3d[:, 2, 2]
    a0 = j00 * s00 + j02 * s02
    a1 = j00 * s01 + j02 * s12
    a2 = j00 * s02 + j02 * s22
    b1 = j11 * s11 + j12 * s12
    b2 = j11 * s12 + j12 * s22
    c_a = a0 * j00 + a2 * j02 + 0.3
    c_b = a1 * j11 + a2 * j12
    c_c = b1 * j11 + b2 * j12 + 0.3
    return torch.stack([c_a, c_b, c_c], dim=-1)


def project_gaussians(mean_cam: torch.Tensor, scales: torch.Tensor,
                      quats: torch.Tensor, cam: Camera,
                      active: torch.Tensor | None = None,
                      w2c_rot: torch.Tensor | None = None,
                      ) -> ProjectedGaussians:
    """Full per-Gaussian stage on camera-frame means. ``active`` masks
    unused capacity slots (they project to radius 0)."""
    x, y, z = mean_cam[:, 0], mean_cam[:, 1], mean_cam[:, 2]
    zsafe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)

    px = cam.fx * x / zsafe + cam.cx - 0.5
    py = cam.fy * y / zsafe + cam.cy - 0.5
    mean2d = torch.stack([px, py], dim=-1)

    cov3d = build_cov3d(scales, quats)
    cov2d = ewa_cov2d(mean_cam, cov3d, cam, w2c_rot)
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_safe = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))

        visible = (z > cam.near_cull) & (det > 0)
        if active is not None:
            visible &= active

        grid_x = -(-cam.width // TILE)
        grid_y = -(-cam.height // TILE)
        # CUDA getRect: min = clamp((p - r) / T), max = clamp((p + r + T-1) / T)
        r = radius_f
        tx0 = to_int32((px - r) / TILE).clamp(0, grid_x)
        ty0 = to_int32((py - r) / TILE).clamp(0, grid_y)
        tx1 = to_int32((px + r + TILE - 1) / TILE).clamp(0, grid_x)
        ty1 = to_int32((py + r + TILE - 1) / TILE).clamp(0, grid_y)
        tiles = (tx1 - tx0) * (ty1 - ty0)
        visible &= tiles > 0

        zero = torch.zeros_like(tiles)
        radius = torch.where(visible, radius_f.to(torch.int32), zero)
        tiles_touched = torch.where(visible, tiles, zero)
        tile_rect = torch.stack([tx0, ty0, tx1, ty1], dim=-1)
        tile_rect = torch.where(visible[:, None], tile_rect,
                                torch.zeros_like(tile_rect))
    return ProjectedGaussians(mean2d=mean2d, conic=conic, depth=z,
                              radius=radius, tile_rect=tile_rect,
                              tiles_touched=tiles_touched)
