"""PoseTable: per-frame learnable SE(3) poses, and the pose-side pieces
(port of ``freesurgs_tpu/models/pose.py``): constant-velocity and PnP
init, the fundamental matrix of two learned poses, the dense Sampson
distance map and its adaptive threshold (the epipolar rigidity mask).

``pnp_pose_init`` solves with the port's own RANSAC PnP on the device
(``models/pnp.py``) where the JAX function calls cv2 on the host; the JAX
function's fallback to the previous pose when cv2 is missing is not
copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.camera import Camera, pixel_grid
from ..core.transforms import (build_w2c, essential_from_poses,
                               fundamental_from_essential, quat_normalize,
                               rotmat_to_quat)
from .pnp import PNP, solve_pnp_ransac


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


def flow_matches(flow_fw: torch.Tensor, cam: Camera):
    """Dense correspondences from a forward flow (the reference's
    ``get_matches``): (pts1 (H*W, 2), pts2 (H*W, 2), valid (H*W,)), valid
    where the flow target lies inside the image."""
    H, W = cam.height, cam.width
    xg, yg = pixel_grid(H, W, device=flow_fw.device)
    p1 = torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=1)
    p2 = p1 + torch.stack([flow_fw[0].reshape(-1), flow_fw[1].reshape(-1)],
                          dim=1)
    valid = ((p2[:, 0] > 0) & (p2[:, 0] < W)
             & (p2[:, 1] > 0) & (p2[:, 1] < H))
    return p1, p2, valid


def pnp_pose_init(poses: PoseTable, t: int, flow_fw_prev: torch.Tensor,
                  prev_depth: torch.Tensor, prev_w2c: torch.Tensor,
                  cam: Camera, max_points: int = 4000,
                  seed: int = 0) -> PoseTable:
    """Initialize frame t by RANSAC PnP (the reference's
    ``initialize_pose(pnp=True)`` branch, whose ``solve_pose_pnp`` the
    reference never defines): frame t-1's pixels back-projected through
    its rendered depth ``prev_depth`` (H, W) into its camera frame, matched
    by ``flow_fw_prev`` (2, H, W) to pixels of frame t; at most
    ``max_points`` of them, drawn with numpy ``default_rng(seed)`` as the
    JAX function draws them. The relative pose composes onto ``prev_w2c``.
    Fewer than 6 usable matches, or a failed solve, copy the previous
    pose. Counted in ``pnp.PNP``."""
    PNP["calls"] += 1
    p1, p2, valid = flow_matches(flow_fw_prev, cam)
    depth = prev_depth.reshape(-1)
    valid = valid & (depth > 0)
    idx = np.flatnonzero(valid.cpu().numpy())
    rng = np.random.default_rng(seed)
    if len(idx) > max_points:
        idx = rng.choice(idx, max_points, replace=False)
    PNP["matches"] += len(idx)
    if len(idx) < 6:
        PNP["fallbacks"] += 1
        return copy_previous_init(poses, t)

    dev = flow_fw_prev.device
    sel = torch.as_tensor(idx, device=dev)
    # back-project frame t-1 pixels into its camera frame (f32, as JAX)
    z = depth[sel].to(torch.float32)
    x = (p1[sel, 0] - cam.cx) / cam.fx * z
    y = (p1[sel, 1] - cam.cy) / cam.fy * z
    obj = torch.stack([x, y, z], -1).to(torch.float64)
    img = p2[sel].to(torch.float64)
    K = torch.as_tensor(cam.intrinsic_matrix(), dtype=torch.float64,
                        device=dev)
    res = solve_pnp_ransac(obj, img, K, reproj_px=3.0, seed=seed)
    if not res.ok:
        PNP["fallbacks"] += 1
        return copy_previous_init(poses, t)

    # rel maps cam(t-1) coordinates to cam(t): w2c_t = rel @ w2c_{t-1}
    rel = torch.eye(4, dtype=torch.float64, device=dev)
    rel[:3, :3] = res.R
    rel[:3, 3] = res.t
    new = rel @ prev_w2c.detach().to(torch.float64)
    q = rotmat_to_quat(new[:3, :3].to(torch.float32))
    return poses.set_frame(t, q.to(poses.quats.dtype),
                           new[:3, 3].to(poses.trans.dtype))
