"""Gauss-Newton flow-PnP pose solve, the tracking init
(port of ``freesurgs_tpu/train/flow_pnp.py``).

Previous-frame pixels back-projected through the cached rendered depth give
3D points X_i; pixel + forward flow gives their observed projections y_i in
the current frame. Minimizing sum_i w_i ||project(T X_i) - y_i||^2 over the
6-DoF pose T is dense PnP with an analytic 2x6 Jacobian per point, solved
by a few Gauss-Newton steps with Huber reweighting (IRLS), Levenberg
damping and a degenerate-frame guard (total weight below ``min_weight``
keeps the init).

Invalid pixels carry zero weight instead of being gathered. The normal
equations reduce over all H*W points: at 1280x1024 that is 1.3M terms per
entry, so they must be summed in true f32 (the JAX version asks for
``Precision.HIGHEST``); ``flow_pnp_refine`` refuses to run on the card with
TF32 matmuls allowed, as ``ops/ssim.py`` does.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera, backproject, pixel_grid
from ..core.transforms import (invert_se3, quat_normalize, quat_to_rotmat,
                               rotmat_to_quat, skew)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential of a (3,) axis-angle vector, finite (with a
    finite gradient) at 0 through Taylor branches below theta^2 = 1e-8."""
    theta2 = torch.sum(omega * omega)
    use_taylor = theta2 < 1e-8
    # the trig branch sees a safe argument at 0, or its 0/0 cotangent
    # poisons the where
    theta2_safe = torch.where(use_taylor, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    K = skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * K + b * (K @ K)


def flow_pnp_refine(quat0, trans0, prev_depth, prev_w2c, flow_fw,
                    cam: Camera, rigid_mask=None, iters: int = 8,
                    huber_px: float = 2.0, damping: float = 1e-4,
                    edge: int = 20, min_weight: float = 64.0):
    """Refine a w2c pose (quat, trans) by dense flow-PnP Gauss-Newton.

    prev_depth (H, W): frame t-1 rendered-depth cache (any float dtype; the
    solve runs in f32). prev_w2c (4, 4): frame t-1 pose. flow_fw (2, H, W):
    forward flow t-1 -> t. rigid_mask (H, W) or None: pixels allowed to vote.

    Returns (quat, trans, diag), diag = [mean |residual| px over the final
    weights, effective point weight]; no gradient flows through it.
    """
    if prev_depth.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("flow_pnp_refine needs full-f32 matmuls: TF32 "
                           "truncation changes the normal equations")
    with torch.no_grad():
        return _refine(quat0, trans0, prev_depth, prev_w2c, flow_fw, cam,
                       rigid_mask, iters, huber_px, damping, edge,
                       min_weight)


def _refine(quat0, trans0, prev_depth, prev_w2c, flow_fw, cam, rigid_mask,
            iters, huber_px, damping, edge, min_weight):
    H, W = cam.height, cam.width
    dev = prev_depth.device
    depth = prev_depth.float()
    pts_world = backproject(depth, cam, invert_se3(prev_w2c))    # (HW, 3)
    xg, yg = pixel_grid(H, W, device=dev)
    pix = torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=1)
    target = pix + torch.stack([flow_fw[0].reshape(-1),
                                flow_fw[1].reshape(-1)], dim=1)  # (HW, 2)
    base_valid = depth.reshape(-1) > 0
    if rigid_mask is not None:
        base_valid = base_valid & (rigid_mask.reshape(-1) > 0)
    base_valid = (base_valid
                  & (target[:, 0] > edge) & (target[:, 0] < W - edge)
                  & (target[:, 1] > edge) & (target[:, 1] < H - edge))

    R = quat_to_rotmat(quat_normalize(quat0))
    t = trans0
    eye6 = torch.eye(6, device=dev)
    mean_r = n_eff = torch.zeros((), device=dev)
    for _ in range(iters):
        p = pts_world @ R.T + t                                  # (HW, 3)
        z = p[:, 2]
        valid = base_valid & (z > 1e-3)
        zs = torch.where(valid, z, torch.ones_like(z))
        a = p[:, 0] / zs
        b = p[:, 1] / zs
        u = a * cam.fx + cam.cx
        v = b * cam.fy + cam.cy
        r = torch.stack([u, v], 1) - target                      # (HW, 2)
        rn = torch.sqrt(torch.sum(r * r, dim=1) + 1e-12)
        # Huber IRLS weight: quadratic inside the knee, linear outside
        w = torch.where(valid,
                        torch.clamp_max(huber_px / torch.clamp_min(rn, 1e-12),
                                        1.0),
                        torch.zeros_like(rn))
        fxz = cam.fx / zs
        fyz = cam.fy / zs
        zero = torch.zeros_like(zs)
        # 2x6 image Jacobian wrt the left-multiplied twist (nu, omega):
        # p' = p + omega x p + nu
        Ju = torch.stack([fxz, zero, -fxz * a, -cam.fx * a * b,
                          cam.fx * (1.0 + a * a), -cam.fx * b], dim=1)
        Jv = torch.stack([zero, fyz, -fyz * b, -cam.fy * (1.0 + b * b),
                          cam.fy * a * b, cam.fy * a], dim=1)
        Hm = (Ju * w[:, None]).T @ Ju + (Jv * w[:, None]).T @ Jv
        g = Ju.T @ (w * r[:, 0]) + Jv.T @ (w * r[:, 1])
        n_eff = torch.sum(w)
        # Levenberg damping scaled to the diagonal keeps the solve sane
        # when the mask is thin or the depth near-planar
        Hm = Hm + damping * torch.diag(torch.diag(Hm)) + 1e-8 * eye6
        # solve_ex: no host sync on the card to check for a singular Hm
        delta = -torch.linalg.solve_ex(Hm, g)[0]
        delta = torch.where(n_eff >= min_weight, delta,
                            torch.zeros_like(delta))
        Rd = so3_exp(delta[3:])
        R = Rd @ R
        t = Rd @ t + delta[:3]
        mean_r = torch.sum(w * rn) / torch.clamp_min(n_eff, 1e-6)
    return rotmat_to_quat(R), t, torch.stack([mean_r, n_eff])
