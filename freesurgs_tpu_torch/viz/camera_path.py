"""Offline camera-path rendering: novel-view fly-throughs (port of
``freesurgs_tpu/viz/camera_path.py``).

The reference's viewer "Render" tab (``vis/render_panel.py``,
nerfstudio-derived spline paths) as an offline tool: a smooth camera path
through (a subset of) the estimated keyframe poses, or an ellipse orbit
fitted to them (the reference's ``setup_ellipse_sampling``,
``scene/pose_optimizer.py:127-161``), each pose rendered and written as a
PNG. Rotations are slerped, translations follow a Catmull-Rom spline.

The path maths is numpy; the rotation <-> quaternion conversions are the
port's float32 ones, as the JAX package converts in float32. Each path
pose is one forward render (``ops/render.render`` without gradients: one
compositing forward launch on the card, no backward).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.camera import Camera
from ..core.transforms import quat_to_rotmat, rotmat_to_quat
from ..ops.render import render
from ..utils.image import colorize_depth, hcat, save_image


def _slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    d = min(d, 1.0)
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(d)
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _catmull_rom(p0, p1, p2, p3, t):
    return 0.5 * ((2 * p1) + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t ** 3)


def interpolate_path(w2cs: np.ndarray, frames_per_segment: int = 10
                     ) -> np.ndarray:
    """Smooth (K-1)*frames_per_segment pose path through (K, 4, 4) keyposes."""
    w2cs = np.asarray(w2cs, np.float64)
    k = len(w2cs)
    rots = torch.from_numpy(w2cs[:, :3, :3].astype(np.float32))
    quats = rotmat_to_quat(rots).numpy()
    trans = w2cs[:, :3, 3]
    out = []
    for i in range(k - 1):
        p0 = trans[max(i - 1, 0)]
        p3 = trans[min(i + 2, k - 1)]
        for f in range(frames_per_segment):
            t = f / frames_per_segment
            q = _slerp(quats[i], quats[i + 1], t)
            p = _catmull_rom(p0, trans[i], trans[i + 1], p3, t)
            w = np.eye(4)
            w[:3, :3] = quat_to_rotmat(
                torch.from_numpy(np.asarray(q, np.float32))).numpy()
            w[:3, 3] = p
            out.append(w)
    return np.stack(out).astype(np.float32)


def ellipse_orbit(w2cs: np.ndarray, num_frames: int = 60,
                  scale: float = 1.0) -> np.ndarray:
    """Ellipse orbit around the trajectory's centroid in the camera-center
    point cloud's principal plane (the reference's ellipse-path idea)."""
    w2cs = np.asarray(w2cs, np.float64)
    R = w2cs[:, :3, :3]
    t = w2cs[:, :3, 3]
    centers = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)
    mu = centers.mean(0)
    c = centers - mu
    if len(c) >= 3 and np.linalg.matrix_rank(c) >= 2:
        _, _, vt = np.linalg.svd(c, full_matrices=False)
        a_dir, b_dir = vt[0], vt[1]
    else:
        a_dir, b_dir = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
    a = max(np.abs(c @ a_dir).max(), 1e-3) * scale
    b = max(np.abs(c @ b_dir).max(), 1e-3) * scale
    # look-at target: the mean camera center pushed along the mean view
    # direction
    fwd = R[:, 2, :].mean(0)
    fwd /= np.linalg.norm(fwd)
    target = mu + fwd * max(a, b) * 2.0

    out = []
    up_hint = R[:, 1, :].mean(0)
    for i in range(num_frames):
        th = 2 * np.pi * i / num_frames
        pos = mu + a * np.cos(th) * a_dir + b * np.sin(th) * b_dir
        z = target - pos
        z /= np.linalg.norm(z)
        x = np.cross(up_hint, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rw = np.stack([x, y, z])        # rows = camera axes -> w2c rotation
        w = np.eye(4)
        w[:3, :3] = Rw
        w[:3, 3] = -Rw @ pos
        out.append(w)
    return np.stack(out).astype(np.float32)


def render_view(field, w2c, cam: Camera, sh_degree: int = 0,
                max_instances: int = 0) -> dict:
    """One forward render of ``field`` at ``w2c`` (numpy or tensor), with
    no autograd graph (grad mode is per thread: the viewer's callbacks
    render from its server's threads)."""
    dev = field.means.device
    if torch.is_tensor(w2c):
        w2c = w2c.detach().to(device=dev, dtype=torch.float32)
    else:
        w2c = torch.as_tensor(np.asarray(w2c, np.float32), device=dev)
    with torch.no_grad():
        return render(field.means, field.quats, field.log_scales,
                      field.logit_opacity, field.sh, w2c, cam,
                      active=field.active, sh_degree=sh_degree,
                      max_instances=max_instances, gs_grad=False,
                      cam_grad=False)


def render_path(field, path_w2cs: np.ndarray, cam: Camera, out_dir: str,
                sh_degree: int = 0, max_instances: int = 0,
                save_depth: bool = False) -> list[np.ndarray]:
    """Render every path pose to <out_dir>/path_####.png; returns the
    frames, (3, H, W) float32 clipped to [0, 1] (with ``save_depth``, each
    beside its colorized depth). ``sh_degree`` 0 is the JAX default: only
    the DC colour of a higher-degree map."""
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i, w2c in enumerate(np.asarray(path_w2cs)):
        out = render_view(field, w2c, cam, sh_degree, max_instances)
        img = torch.clamp(out["render"], 0, 1).cpu().numpy()
        if save_depth:
            img = hcat(img, colorize_depth(out["render_dep"].cpu().numpy()))
        save_image(img, os.path.join(out_dir, f"path_{i:04d}.png"))
        frames.append(img)
    return frames
