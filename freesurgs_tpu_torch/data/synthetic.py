"""Synthetic video for end-to-end runs without SCARED data
(port of ``freesurgs_tpu/data/synthetic.py``).

A random Gaussian scene, a smooth ground-truth camera trajectory, frames
rendered with the port's own renderer, analytic optical flow from rendered
depth and the ground-truth relative poses, and a "monocular depth" prior:
the rendered depth min-max normalized into [0.5, 1.5] as the reference
preprocesses it. ``make_nonrigid_scene`` adds a deforming patch and a
moving specular highlight, the content the epipolar rigidity mask exists
to exclude, with their ground-truth masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import Camera, backproject, pixel_grid, project
from ..core.sh import rgb2sh
from ..core.transforms import build_w2c, invert_se3, transform_points
from ..ops.render import render


class SyntheticScene(NamedTuple):
    cam: Camera
    means: torch.Tensor
    quats: torch.Tensor
    log_scales: torch.Tensor
    logit_opacity: torch.Tensor
    sh: torch.Tensor
    gt_w2c: torch.Tensor        # (T, 4, 4)
    gt_quats: torch.Tensor      # (T, 4)
    gt_trans: torch.Tensor      # (T, 3)
    colors: torch.Tensor        # (T, 3, H, W)
    depths: torch.Tensor        # (T, H, W)
    monodeps: torch.Tensor      # (T, H, W)
    flows_fw: torch.Tensor      # (T-1, 2, H, W)


def _smooth_trajectory(num_frames: int, seed: int, rot_mag=0.02,
                       trans_mag=0.015, revert=0.06):
    """Mean-reverting camera path (an Ornstein-Uhlenbeck walk on a small
    rotation vector and the translation), as float32 numpy (T, 4), (T, 3)."""
    rng = np.random.default_rng(seed)
    qs = [np.array([1.0, 0, 0, 0])]
    ts = [np.zeros(3)]
    v = np.zeros(3)
    p = np.zeros(3)
    dq = rng.normal(size=3) * rot_mag
    dt = rng.normal(size=3) * trans_mag
    for _ in range(1, num_frames):
        dq = 0.9 * dq + rng.normal(size=3) * rot_mag * 0.3 - revert * v
        dt = 0.9 * dt + rng.normal(size=3) * trans_mag * 0.3 - revert * p
        v = v + dq
        p = p + dt
        q = np.concatenate([[1.0], v])
        qs.append(q / np.linalg.norm(q))
        ts.append(p.copy())
    return (np.stack(qs).astype(np.float32), np.stack(ts).astype(np.float32))


def _random_field(rng, n: int, scale_range):
    """The JAX recipe's draws of n Gaussians, in its order: means, quats,
    log-scales, opacity logits and colors, as float32 numpy."""
    means = np.stack([
        rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
        rng.uniform(1.0, 2.5, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    log_scales = np.log(rng.uniform(*scale_range, (n, 3))).astype(np.float32)
    logit_op = rng.uniform(1.0, 4.0, n).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return means, quats, log_scales, logit_op, rgb


def _monodeps(depths: torch.Tensor) -> torch.Tensor:
    """The reference's mono-depth prior: each frame's depth min-max
    normalized into [0.5, 1.5]."""
    dmin = depths.amin(dim=(1, 2), keepdim=True)
    dmax = depths.amax(dim=(1, 2), keepdim=True)
    return (depths - dmin) / torch.clamp_min(dmax - dmin, 1e-8) + 0.5


def flow_from_depth(depth_t, w2c_t, w2c_t1, cam: Camera) -> torch.Tensor:
    """Analytic forward flow t -> t+1 from frame t's depth and both poses."""
    pts_w = backproject(depth_t, cam, invert_se3(w2c_t))
    proj, _ = project(transform_points(w2c_t1, pts_w), cam)
    xg, yg = pixel_grid(cam.height, cam.width, device=depth_t.device)
    pix = torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=1)
    return (proj - pix).T.reshape(2, cam.height, cam.width)


def make_scene(num_frames: int = 8, n_gaussians: int = 600,
               height: int = 64, width: int = 80, seed: int = 0,
               scale_range: tuple = (0.02, 0.06),
               device="cuda") -> SyntheticScene:
    """The JAX ``make_scene`` recipe: the same numpy draws from ``seed``,
    rendered by the port (its compositing kernels on the card)."""
    rng = np.random.default_rng(seed)
    cam = Camera(height=height, width=width, fx=width * 1.1, fy=width * 1.1,
                 cx=width / 2, cy=height / 2)
    n = n_gaussians
    means, quats, log_scales, logit_op, rgb = _random_field(rng, n,
                                                            scale_range)

    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(x, device=dev)

    sh = rgb2sh(t(rgb))[:, None, :]
    gq, gt = _smooth_trajectory(num_frames, seed + 1)
    gt_q, gt_t = t(gq), t(gt)
    gt_w2c = build_w2c(gt_q, gt_t)
    args = (t(means), t(quats), t(log_scales), t(logit_op), sh)

    colors, depths = [], []
    with torch.no_grad():
        for i in range(num_frames):
            out = render(*args, gt_w2c[i], cam)
            if i == 0 and int(out["overflow"]) != 0:
                raise ValueError(f"instance overflow {int(out['overflow'])}: "
                                 "shrink scale_range")
            colors.append(torch.clamp(out["render"], 0.0, 1.0))
            depths.append(out["render_dep"])
        colors = torch.stack(colors)
        depths = torch.stack(depths)
        monodeps = _monodeps(depths)
        flows = torch.stack([
            flow_from_depth(depths[i], gt_w2c[i], gt_w2c[i + 1], cam)
            for i in range(num_frames - 1)])
    return SyntheticScene(cam=cam, means=args[0], quats=args[1],
                          log_scales=args[2], logit_opacity=args[3], sh=sh,
                          gt_w2c=gt_w2c, gt_quats=gt_q, gt_trans=gt_t,
                          colors=colors, depths=depths, monodeps=monodeps,
                          flows_fw=flows)


def make_nonrigid_scene(num_frames: int = 8, n_gaussians: int = 600,
                        height: int = 64, width: int = 80, seed: int = 0,
                        scale_range: tuple = (0.02, 0.06),
                        patch_amp: float = 0.02, spec_speed: float = 0.02,
                        device="cuda"):
    """The JAX ``make_nonrigid_scene``: ``make_scene``'s field plus
    non-rigid content that the epipolar rigidity mask exists to exclude,
    from the same numpy draws of ``seed`` in the same order:

    - a deforming patch: the Gaussians inside a ball sway together along
      one direction, sinusoidally over ~10 frames;
    - a moving specular highlight: 24 bright compact Gaussians drifting
      laterally with their own velocity.

    Each frame is rendered twice: its colors, and a membership render (red
    = patch, green = highlight, on a black background). The analytic flow
    follows the true scene motion: each pixel's back-projection is moved by
    its memberships times the objects' world displacements before it is
    reprojected, so non-rigid pixels carry flow that violates the epipolar
    constraint.

    Returns ``(SyntheticScene, aux)``, aux holding per-frame memberships
    ``member_patch`` / ``member_spec`` (T, H, W) and the ground truth
    ``nonrigid_mask`` (T, H, W) bool (memberships summing over 0.3).
    """
    rng = np.random.default_rng(seed)
    cam = Camera(height=height, width=width, fx=width * 1.1, fy=width * 1.1,
                 cx=width / 2, cy=height / 2)
    n = n_gaussians
    means, quats, log_scales, logit_op, rgb = _random_field(rng, n,
                                                            scale_range)

    # the deforming patch: a ball in the central near field
    patch_center = np.array([0.15, -0.1, 1.4], np.float32)
    patch_sel = (np.linalg.norm(means - patch_center, axis=1)
                 < 0.3).astype(np.float32)
    sway_dir = np.array([0.8, 0.55, -0.25], np.float32)
    sway_dir /= np.linalg.norm(sway_dir)

    def patch_disp(t):
        return (patch_amp * np.sin(2 * np.pi * t / 10.0)
                * sway_dir).astype(np.float32)

    # the specular highlight: a bright compact cluster with its own drift
    n_spec = 24
    spec_base = np.array([-0.3, 0.1, 1.3], np.float32)
    spec_vel = np.array([spec_speed, -0.4 * spec_speed, 0.0], np.float32)
    spec_local = (rng.normal(size=(n_spec, 3)) * 0.02).astype(np.float32)
    spec_quats = rng.normal(size=(n_spec, 4)).astype(np.float32)
    spec_ls = np.log(rng.uniform(0.01, 0.02, (n_spec, 3))).astype(np.float32)
    spec_op = np.full((n_spec,), 2.0, np.float32)

    def spec_pos(t):
        return spec_base + t * spec_vel

    dev = torch.device(device)

    def t_(x):
        return torch.as_tensor(x, device=dev)

    gq, gt = _smooth_trajectory(num_frames, seed + 1)
    gt_q, gt_t = t_(gq), t_(gt)
    gt_w2c = build_w2c(gt_q, gt_t)

    sh = torch.cat([rgb2sh(t_(rgb)),
                    rgb2sh(torch.full((n_spec, 3), 0.98, device=dev))]
                   )[:, None, :]
    all_quats = t_(np.concatenate([quats, spec_quats]))
    all_ls = t_(np.concatenate([log_scales, spec_ls]))
    all_op = t_(np.concatenate([logit_op, spec_op]))
    # membership indicator colors: R = patch, G = highlight
    ind = np.zeros((n + n_spec, 3), np.float32)
    ind[:n, 0] = patch_sel
    ind[n:, 1] = 1.0
    ind_sh = rgb2sh(t_(ind))[:, None, :]
    black = torch.zeros(3, device=dev)

    def means_at(t):
        m = means + patch_sel[:, None] * patch_disp(t)[None, :]
        return t_(np.concatenate([m, spec_local + spec_pos(t)[None, :]]))

    colors, depths, mem_p, mem_s = [], [], [], []
    with torch.no_grad():
        for i in range(num_frames):
            m_t = means_at(i)
            out = render(m_t, all_quats, all_ls, all_op, sh, gt_w2c[i], cam)
            colors.append(torch.clamp(out["render"], 0.0, 1.0))
            depths.append(out["render_dep"])
            memb = render(m_t, all_quats, all_ls, all_op, ind_sh, gt_w2c[i],
                          cam, bg=black)["render"]
            mem_p.append(torch.clamp(memb[0], 0.0, 1.0))
            mem_s.append(torch.clamp(memb[1], 0.0, 1.0))
        colors = torch.stack(colors)
        depths = torch.stack(depths)
        mem_p = torch.stack(mem_p)
        mem_s = torch.stack(mem_s)
        monodeps = _monodeps(depths)

        xg, yg = pixel_grid(cam.height, cam.width, device=dev)
        pix = torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=1)
        flows = []
        for i in range(num_frames - 1):
            pts = backproject(depths[i], cam, invert_se3(gt_w2c[i]))
            dp = t_(patch_disp(i + 1) - patch_disp(i))
            ds = t_(spec_vel)
            pts1 = (pts + mem_p[i].reshape(-1, 1) * dp[None, :]
                    + mem_s[i].reshape(-1, 1) * ds[None, :])
            proj, _ = project(transform_points(gt_w2c[i + 1], pts1), cam)
            flows.append((proj - pix).T.reshape(2, cam.height, cam.width))
        flows = torch.stack(flows)

    scene = SyntheticScene(cam=cam, means=means_at(0), quats=all_quats,
                           log_scales=all_ls, logit_opacity=all_op, sh=sh,
                           gt_w2c=gt_w2c, gt_quats=gt_q, gt_trans=gt_t,
                           colors=colors, depths=depths, monodeps=monodeps,
                           flows_fw=flows)
    aux = {"member_patch": mem_p, "member_spec": mem_s,
           "nonrigid_mask": (mem_p + mem_s) > 0.3}
    return scene, aux


class SceneSequence:
    """The VideoSequence interface over a scene: every frame a train frame
    unless ``i_test`` names some (those are tracked and cached, not
    mapped)."""

    def __init__(self, scene, i_test=()):
        self.cam = scene.cam
        self.colors = scene.colors
        self.monodeps = scene.monodeps
        self.flows_fw = scene.flows_fw
        n = int(scene.colors.shape[0])
        test = set(int(i) for i in i_test)
        self.i_train = np.asarray([i for i in range(n) if i not in test])
        self.i_test = np.asarray(sorted(test), dtype=np.int64)
