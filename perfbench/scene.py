"""The benchmark's input sequence: the full-res synthetic SCARED stand-in,
made in memory on the device from the seed.

SCARED itself is access-gated, so Free-SurGS runs here on the synthetic
recipe of ``make_fullres_dataset`` (1280x1024, 20,000 random Gaussians with
scales 0.004-0.012 at depths 1.0-2.5, a mean-reverting camera path of 60
frames): the same numpy draws from the seed in the same order, each frame
rendered by the plain reference renderer (``reference/render.py``), then
the arithmetic of writing the sequence in the SCARED layout and loading
it back, without the files: colours as 8-bit PNG values (x * 255
truncated, / 255), the depth prior as 1 / (1 / depth) through float32
disparity, normalized per frame into [0.5, 1.5] or kept metric, the
intrinsics rounded to float32, test frames ``sample_rate // 2 ::
sample_rate``, the first ``frames`` frames kept, forward flow from the
rendered depth and the true poses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import render as R


@dataclasses.dataclass
class Sequence:
    """What a training job reads, on the device: colors (T, 3, H, W),
    monodeps (T, H, W), flows_fw (T-1, 2, H, W), the camera, the split, and
    the ground-truth world-to-camera poses (T, 4, 4) float64 (frame 0 the
    identity). ``K`` is the float32 intrinsic matrix a loader reads."""
    colors: torch.Tensor
    monodeps: torch.Tensor
    flows_fw: torch.Tensor
    K: np.ndarray
    height: int
    width: int
    i_train: np.ndarray
    i_test: np.ndarray
    gt_w2c: np.ndarray

    @property
    def cam(self) -> R.Cam:
        return R.Cam(self.height, self.width, float(self.K[0, 0]),
                     float(self.K[1, 1]), float(self.K[0, 2]),
                     float(self.K[1, 2]))

    @property
    def w2c(self) -> torch.Tensor:
        return torch.as_tensor(self.gt_w2c.astype(np.float32),
                               device=self.colors.device)

    @property
    def prior(self) -> torch.Tensor:
        return self.monodeps


def trajectory(num_frames: int, seed: int, rot_mag=0.02, trans_mag=0.015,
               revert=0.06):
    """The recipe's camera path: an Ornstein-Uhlenbeck walk on a small
    rotation vector and the translation; float32 (T, 4) (w, x, y, z) and
    (T, 3)."""
    rng = np.random.default_rng(seed)
    qs, ts = [np.array([1.0, 0, 0, 0])], [np.zeros(3)]
    v, p = np.zeros(3), np.zeros(3)
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
    return np.stack(qs).astype(np.float32), np.stack(ts).astype(np.float32)


def _w2c(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(q.shape[0], 4, 4, device=q.device)
    T[:, :3, :3] = R.quat_rotmat(q)
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T


def _flow(depth, w2c0, w2c1, cam: R.Cam) -> torch.Tensor:
    """Forward flow (2, H, W) of frame 0's pixels at ``depth`` into the
    frame of ``w2c1`` (projection with z + 1e-5, pixel centres at
    integers)."""
    h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device,
                                         dtype=torch.float32),
                            torch.arange(w, device=depth.device,
                                         dtype=torch.float32), indexing="ij")
    z = depth.reshape(-1)
    pts = torch.stack([(xs.reshape(-1) - cam.cx) / cam.fx * z,
                       (ys.reshape(-1) - cam.cy) / cam.fy * z, z], -1)
    c2w = torch.linalg.inv(w2c0)
    world = pts @ c2w[:3, :3].T + c2w[:3, 3]
    pc = world @ w2c1[:3, :3].T + w2c1[:3, 3]
    zz = pc[:, 2] + 1e-5
    u = pc[:, 0] / zz * cam.fx + cam.cx
    v = pc[:, 1] / zz * cam.fy + cam.cy
    return torch.stack([u - xs.reshape(-1), v - ys.reshape(-1)]
                       ).reshape(2, h, w)


def make_sequence(seed: int, spec: dict, device) -> Sequence:
    """The sequence of a configuration's ``scene`` and ``data`` entries
    (sizes, Gaussians, scale range, frames generated and kept, sample rate,
    depth prior) from ``seed``."""
    sc, data = spec["scene"], spec["data"]
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
    gq, gt = trajectory(n_gen, seed + 1)

    def t(x):
        return torch.as_tensor(x, device=dev)

    field = {"means": t(means), "quats": t(quats), "log_scales": t(log_scales),
             "logit_opacity": t(logit_op),
             "sh_dc": ((t(rgb) - 0.5) / R.SH_C0)[:, None, :],
             "sh_rest": torch.zeros(n, 0, 3, device=dev)}
    active = torch.ones(n, dtype=torch.bool, device=dev)
    cam = R.Cam(h, w, w * 1.1, w * 1.1, w / 2, h / 2)
    w2c = _w2c(t(gq), t(gt))[:n_keep]
    colors, depths = [], []
    with torch.no_grad():
        for i in range(n_keep):
            out = R.render(field, active, w2c[i], cam, 0)[2]
            colors.append(torch.clamp(out["image"][0:3], 0.0, 1.0))
            depths.append(out["image"][3])
        depths = torch.stack(depths)
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
        flows = torch.stack([_flow(depths[i], w2c[i], w2c[i + 1], cam)
                             for i in range(n_keep - 1)])
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                  [0.0, 0.0, 1.0]], np.float32)
    rate = data["sample_rate"]
    i_test = np.arange(n_keep)[rate // 2::rate]
    i_train = np.array([i for i in range(n_keep) if i not in set(i_test)])
    return Sequence(colors=colors, monodeps=prior, flows_fw=flows, K=K,
                    height=h, width=w, i_train=i_train, i_test=i_test,
                    gt_w2c=w2c.cpu().numpy().astype(np.float64))
