"""Pinhole camera model (port of ``freesurgs_tpu/core/camera.py``).

Projection is parameterized directly by (fx, fy, cx, cy): the reference's
OpenGL projection composed with the CUDA kernel's NDC->pixel map reduces
to ``pix_x = fx*x/z + cx - 0.5``. ``Camera`` is a frozen (hashable)
dataclass, like the JAX one.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def focal2fov(focal: float, pixels: int) -> float:
    """Reference: ``utils/graphics_utils.py:128-132``."""
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov * 0.5))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static pinhole camera. ``near_cull`` is the CUDA kernel's hard-coded
    z <= 0.2 frustum cull, independent of ``znear``."""

    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    znear: float = 0.01
    zfar: float = 100.0
    near_cull: float = 0.2

    @property
    def fov_x(self) -> float:
        return focal2fov(self.fx, self.width)

    @property
    def fov_y(self) -> float:
        return focal2fov(self.fy, self.height)

    @property
    def tan_fov_x(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fov_y(self) -> float:
        return self.height / (2.0 * self.fy)

    def intrinsic_matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32)

    @classmethod
    def from_K(cls, K, height: int, width: int, **kw) -> "Camera":
        """The camera of a 3x3 intrinsic matrix at (height, width)."""
        K = np.asarray(K)
        return cls(height=int(height), width=int(width), fx=float(K[0, 0]),
                   fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
                   **kw)


def opengl_projection_matrix(cam: Camera) -> np.ndarray:
    """The reference's intrinsics-based OpenGL projection
    (``scene/pose_optimizer.py:614-617``), for viewer interop; the render
    path does not use it."""
    w, h = cam.width, cam.height
    near, far = cam.znear, cam.zfar
    return np.array([
        [2 * cam.fx / w, 0.0, -(w - 2 * cam.cx) / w, 0.0],
        [0.0, 2 * cam.fy / h, -(h - 2 * cam.cy) / h, 0.0],
        [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
        [0.0, 0.0, 1.0, 0.0],
    ], dtype=np.float32)


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None):
    """(H, W) x / y pixel-coordinate grids (pixel centers at integers)."""
    ys = torch.arange(height, dtype=dtype, device=device)
    xs = torch.arange(width, dtype=dtype, device=device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return xg, yg


def backproject(depth: torch.Tensor, cam: Camera,
                c2w: torch.Tensor | None = None) -> torch.Tensor:
    """Back-project an (H, W) depth map to (H*W, 3) points (world frame if
    ``c2w`` is given). The grid and the camera-frame points are in the
    depth's dtype; the transform promotes them to ``c2w``'s, as JAX does."""
    H, W = depth.shape[-2], depth.shape[-1]
    xg, yg = pixel_grid(H, W, dtype=depth.dtype, device=depth.device)
    z = depth.reshape(-1)
    x = (xg.reshape(-1) - cam.cx) / cam.fx * z
    y = (yg.reshape(-1) - cam.cy) / cam.fy * z
    pts = torch.stack([x, y, z], dim=-1)
    if c2w is not None:
        pts = pts.to(torch.promote_types(pts.dtype, c2w.dtype))
        pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    return pts


def project(pts_cam: torch.Tensor, cam: Camera, eps: float = 1e-5):
    """(N, 3) camera-frame points -> ((N, 2) pixels, (N,) depth), with the
    K @ p convention of the flow-reprojection code."""
    z = pts_cam[..., 2:3] + eps
    u = pts_cam[..., 0:1] / z * cam.fx + cam.cx
    v = pts_cam[..., 1:2] / z * cam.fy + cam.cy
    return torch.cat([u, v], dim=-1), pts_cam[..., 2]
