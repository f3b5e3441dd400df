"""The non-rigid benchmark sequence: the full-res synthetic SCARED stand-in
of ``make_fullres_dataset --nonrigid``, made in memory on the device from
the seed.

The rigid recipe of ``scene.py`` plus the content that the epipolar
rigidity mask exists to exclude (deforming tissue and a moving specular
highlight), with the geometry of the configuration's ``scene.nonrigid``
entry:

- a deforming patch: the Gaussians within ``patch_radius`` of
  ``patch_center`` sway together along ``sway_dir`` (normalized) by
  ``patch_amp * sin(2 pi t / sway_period_frames)``;
- a moving highlight: ``highlights`` bright compact Gaussians at
  ``highlight_base`` + a local offset (normal, ``highlight_spread``),
  drifting by ``spec_speed * highlight_velocity`` a frame, with scales in
  ``highlight_scale_range``, opacity logit ``highlight_logit_opacity`` and
  grey colour ``highlight_color``.

The numpy draws follow the port's generator in its order (the field as in
``scene.py``, then each highlight's offset, quaternion and scales; the
camera path from ``seed + 1``). Each frame is drawn twice by the plain
renderer (``reference/render.py``): its colours, and a membership render
(red = patch, green = highlight) on a black background, the white
background's T_final taken back out. Then the load side of ``scene.py``:
8-bit colours, the depth prior through float32 disparity, the split. The
forward flow moves each pixel's back-projection by its memberships times
the objects' world displacements between the two frames before it is
reprojected (z + 1e-5, pixel centres at integers), so non-rigid pixels
carry flow that breaks the epipolar constraint. ``nonrigid_mask`` is the
ground truth: memberships summing over ``member_threshold``.

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import render as R
from .scene import Sequence, _w2c, trajectory


@dataclasses.dataclass
class NonrigidSequence(Sequence):
    """``scene.Sequence`` with the ground-truth non-rigid pixels (T, H, W)
    bool of each kept frame."""
    nonrigid_mask: torch.Tensor


def _displaced_flow(depth, w2c0, w2c1, disp, cam: R.Cam) -> torch.Tensor:
    """Forward flow (2, H, W) of frame 0's pixels at ``depth``, each world
    point moved by ``disp`` (H*W, 3), into the frame of ``w2c1``."""
    h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device,
                                         dtype=torch.float32),
                            torch.arange(w, device=depth.device,
                                         dtype=torch.float32), indexing="ij")
    z = depth.reshape(-1)
    pts = torch.stack([(xs.reshape(-1) - cam.cx) / cam.fx * z,
                       (ys.reshape(-1) - cam.cy) / cam.fy * z, z], -1)
    c2w = torch.linalg.inv(w2c0)
    world = pts @ c2w[:3, :3].T + c2w[:3, 3] + disp
    pc = world @ w2c1[:3, :3].T + w2c1[:3, 3]
    zz = pc[:, 2] + 1e-5
    u = pc[:, 0] / zz * cam.fx + cam.cx
    v = pc[:, 1] / zz * cam.fy + cam.cy
    return torch.stack([u - xs.reshape(-1), v - ys.reshape(-1)]
                       ).reshape(2, h, w)


def make_sequence(seed: int, spec: dict, device) -> NonrigidSequence:
    """The sequence of a configuration's ``scene`` (with its ``nonrigid``
    entry) and ``data`` entries from ``seed``."""
    sc, data, nr = spec["scene"], spec["data"], spec["scene"]["nonrigid"]
    h, w = spec["image"]["height"], spec["image"]["width"]
    n, n_gen, n_keep = sc["gaussians"], sc["frames_generated"], data["frames"]
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.0, 2.5, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    log_scales = np.log(rng.uniform(*sc["scale_range"], (n, 3))
                        ).astype(np.float32)
    logit_op = rng.uniform(1.0, 4.0, n).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)

    centre = np.array(nr["patch_center"], np.float32)
    in_patch = (np.linalg.norm(means - centre, axis=1)
                < nr["patch_radius"]).astype(np.float32)
    sway = np.array(nr["sway_dir"], np.float32)
    sway /= np.linalg.norm(sway)
    amp, period = nr["patch_amp"], nr["sway_period_frames"]

    def patch_disp(t):
        return (amp * np.sin(2 * np.pi * t / period) * sway).astype(
            np.float32)

    n_hl = nr["highlights"]
    hl_base = np.array(nr["highlight_base"], np.float32)
    hl_vel = (nr["spec_speed"] * np.array(nr["highlight_velocity"])
              ).astype(np.float32)
    hl_local = (rng.normal(size=(n_hl, 3)) * nr["highlight_spread"]
                ).astype(np.float32)
    hl_quats = rng.normal(size=(n_hl, 4)).astype(np.float32)
    hl_ls = np.log(rng.uniform(*nr["highlight_scale_range"], (n_hl, 3))
                   ).astype(np.float32)
    hl_op = np.full((n_hl,), nr["highlight_logit_opacity"], np.float32)
    gq, gt = trajectory(n_gen, seed + 1)

    def t_(x):
        return torch.as_tensor(x, device=dev)

    def means_at(t):
        m = means + in_patch[:, None] * patch_disp(t)[None, :]
        return t_(np.concatenate([m, hl_local + (hl_base + t * hl_vel)[None]]))

    colour = torch.cat([t_(rgb), torch.full((n_hl, 3), nr["highlight_color"],
                                            device=dev)])
    member = np.zeros((n + n_hl, 3), np.float32)
    member[:n, 0] = in_patch
    member[n:, 1] = 1.0
    field = {"quats": t_(np.concatenate([quats, hl_quats])),
             "log_scales": t_(np.concatenate([log_scales, hl_ls])),
             "logit_opacity": t_(np.concatenate([logit_op, hl_op])),
             "sh_rest": torch.zeros(n + n_hl, 0, 3, device=dev)}
    sh_colour = ((colour - 0.5) / R.SH_C0)[:, None, :]
    sh_member = ((t_(member) - 0.5) / R.SH_C0)[:, None, :]
    active = torch.ones(n + n_hl, dtype=torch.bool, device=dev)
    cam = R.Cam(h, w, w * 1.1, w * 1.1, w / 2, h / 2)
    w2c = _w2c(t_(gq), t_(gt))[:n_keep]
    colors, depths, mem_p, mem_s = [], [], [], []
    with torch.no_grad():
        for i in range(n_keep):
            f = dict(field, means=means_at(i))
            out = R.render(dict(f, sh_dc=sh_colour), active, w2c[i], cam,
                           0)[2]
            colors.append(torch.clamp(out["image"][0:3], 0.0, 1.0))
            depths.append(out["image"][3])
            # the membership render on black: T_final taken back out
            m = R.render(dict(f, sh_dc=sh_member), active, w2c[i], cam,
                         0)[2]
            memb = torch.clamp(m["image"][0:2] - m["final_T"][None], 0.0,
                               1.0)
            mem_p.append(memb[0])
            mem_s.append(memb[1])
        depths = torch.stack(depths)
        mem_p, mem_s = torch.stack(mem_p), torch.stack(mem_s)
        # the PNG round trip, then the prior through float32 disparity
        colors = (torch.stack(colors) * 255).to(torch.uint8).to(
            torch.float32) / 255.0
        prior = 1.0 / torch.clamp(1.0 / torch.clamp_min(depths, 1e-6),
                                  1e-6, 1e6)
        if data["depth_prior"] == "normalized":
            lo = prior.amin(dim=(1, 2), keepdim=True)
            hi = prior.amax(dim=(1, 2), keepdim=True)
            prior = (prior - lo) / torch.clamp_min(hi - lo, 1e-12) + 0.5
        elif data["depth_prior"] != "metric":
            raise ValueError(f"depth_prior {data['depth_prior']!r}")
        flows = []
        for i in range(n_keep - 1):
            dp = t_(patch_disp(i + 1) - patch_disp(i))
            disp = mem_p[i].reshape(-1, 1) * dp[None, :] + \
                mem_s[i].reshape(-1, 1) * t_(hl_vel)[None, :]
            flows.append(_displaced_flow(depths[i], w2c[i], w2c[i + 1], disp,
                                         cam))
        flows = torch.stack(flows)
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                  [0.0, 0.0, 1.0]], np.float32)
    rate = data["sample_rate"]
    i_test = np.arange(n_keep)[rate // 2::rate]
    i_train = np.array([i for i in range(n_keep) if i not in set(i_test)])
    return NonrigidSequence(
        colors=colors, monodeps=prior, flows_fw=flows, K=K, height=h,
        width=w, i_train=i_train, i_test=i_test,
        gt_w2c=w2c.cpu().numpy().astype(np.float64),
        nonrigid_mask=(mem_p + mem_s) > nr["member_threshold"])
