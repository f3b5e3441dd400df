"""PoseTable: per-frame learnable SE(3) poses, and the pose-side pieces
(port of ``freesurgs_tpu/models/pose.py``): constant-velocity init, the
fundamental matrix of two learned poses, the dense Sampson distance map
and its adaptive threshold (the epipolar rigidity mask).

``pnp_pose_init`` and ``flow_matches`` wait for a later slice
(``pose_init="pnp"`` is not the default).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import Camera, pixel_grid
from ..core.transforms import (build_w2c, essential_from_poses,
                               fundamental_from_essential, quat_normalize)


@dataclasses.dataclass
class PoseTable:
    quats: torch.Tensor   # (T, 4) unnormalized (w, x, y, z)
    trans: torch.Tensor   # (T, 3)

    @property
    def num_frames(self) -> int:
        return self.quats.shape[0]

    def w2c(self, t) -> torch.Tensor:
        return build_w2c(self.quats[t], self.trans[t])

    def all_w2c(self) -> torch.Tensor:
        return build_w2c(self.quats, self.trans)

    def set_frame(self, t, quat, trans) -> "PoseTable":
        q = self.quats.clone()
        tr = self.trans.clone()
        q[t] = quat
        tr[t] = trans
        return PoseTable(quats=q, trans=tr)


def identity_poses(num_frames: int, device="cuda") -> PoseTable:
    quats = torch.zeros(num_frames, 4, device=device)
    quats[:, 0] = 1.0
    return PoseTable(quats=quats, trans=torch.zeros(num_frames, 3,
                                                    device=device))


def const_velocity_init(poses: PoseTable, t: int) -> PoseTable:
    """new_q = normalize(q1 + (q1 - q2)), new_t = t1 + (t1 - t2) from frames
    t-1, t-2 (t >= 2)."""
    q1 = quat_normalize(poses.quats[t - 1])
    q2 = quat_normalize(poses.quats[t - 2])
    new_q = quat_normalize(q1 + (q1 - q2))
    tr1 = poses.trans[t - 1]
    tr2 = poses.trans[t - 2]
    return poses.set_frame(t, new_q, tr1 + (tr1 - tr2))


def copy_previous_init(poses: PoseTable, t: int) -> PoseTable:
    return poses.set_frame(t, poses.quats[t - 1], poses.trans[t - 1])


def fundamental_matrix(poses: PoseTable, t1: int, t2: int,
                       K: torch.Tensor) -> torch.Tensor:
    E = essential_from_poses(poses.w2c(t1), poses.w2c(t2))
    return fundamental_from_essential(E, K, K)


def sampson_distance(F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """First-order epipolar (Sampson) distance of (N, 2) pixel matches."""
    ones = torch.ones_like(pts1[:, :1])
    x1 = torch.cat([pts1, ones], dim=1)
    x2 = torch.cat([pts2, ones], dim=1)
    Fx1 = x1 @ F.T
    Ftx2 = x2 @ F
    num = torch.sum(x2 * Fx1, dim=1) ** 2
    den = (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2
           + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)
    return num / (den + eps)


def epipolar_rigidity(poses: PoseTable, t1: int, t2: int,
                      flow_fw: torch.Tensor, cam: Camera, K: torch.Tensor):
    """Dense Sampson distance map t1 -> t2: (mean, map (H, W)); flow targets
    outside the image get distance 0."""
    H, W = cam.height, cam.width
    xg, yg = pixel_grid(H, W, device=flow_fw.device)
    p1 = torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=1)
    p2 = p1 + torch.stack([flow_fw[0].reshape(-1), flow_fw[1].reshape(-1)],
                          dim=1)
    F = fundamental_matrix(poses, t1, t2, K)
    d = sampson_distance(F, p1, p2)
    in_bounds = ((p2[:, 0] > 0) & (p2[:, 0] < W)
                 & (p2[:, 1] > 0) & (p2[:, 1] < H))
    d = torch.where(in_bounds, d, torch.zeros_like(d))
    return torch.mean(d), d.reshape(H, W)


def adaptive_threshold_mask(x: torch.Tensor, factor: float = 2.0):
    """mask = x <= mean + factor * std (population std)."""
    return x <= (torch.mean(x) + factor * torch.std(x, unbiased=False))
