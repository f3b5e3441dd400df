"""GaussianField: the learnable scene state as a fixed-capacity slot pool
(port of ``freesurgs_tpu/models/gaussians.py``).

All per-slot tensors have leading dim ``capacity``; ``active`` marks live
slots (inactive ones are culled in projection). Densify and prune write
into free slots at constant shape (``train/densify.py``), and the host
grows the capacity at 90% occupancy. Parameterization is the reference's:
means (N, 3) | quats (N, 4) unnormalized | log_scales (N, 3) |
logit_opacity (N,) | sh_dc (N, 1, 3) | sh_rest (N, K-1, 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import sh as shlib
from ..core.camera import Camera, backproject
from ..core.transforms import invert_se3
from ..ops.knn import initial_log_scales

PARAM_NAMES = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
               "sh_rest")


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianField:
    means: torch.Tensor
    quats: torch.Tensor
    log_scales: torch.Tensor
    logit_opacity: torch.Tensor
    sh_dc: torch.Tensor
    sh_rest: torch.Tensor
    active: torch.Tensor          # (C,) bool
    max_radii2d: torch.Tensor     # (C,) f32
    grad_accum: torch.Tensor      # (C,) f32 — sum of ||dL/d mean2d||
    grad_denom: torch.Tensor      # (C,) f32
    scene_radius: torch.Tensor    # () f32
    max_sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active)

    @property
    def sh(self) -> torch.Tensor:
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)

    def param_dict(self) -> dict[str, torch.Tensor]:
        """The six optimizer-visible tensors (per-group LRs key off these)."""
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def replace(self, **kw) -> "GaussianField":
        return dataclasses.replace(self, **kw)

    def reset_stats(self) -> "GaussianField":
        return self.replace(max_radii2d=torch.zeros_like(self.max_radii2d),
                            grad_accum=torch.zeros_like(self.grad_accum),
                            grad_denom=torch.zeros_like(self.grad_denom))


def _round_capacity(n: int, quantum: int = 4096) -> int:
    return max(-(-n // quantum) * quantum, quantum)


def from_pointcloud(points: torch.Tensor, colors: torch.Tensor,
                    scene_radius, max_sh_degree: int = 3,
                    capacity: int | None = None,
                    init_opacity: float = 0.1) -> GaussianField:
    """Initialize from (N, 3) points + (N, 3) rgb: identity quats,
    opacity logit(0.1), scales from the 3-NN mean squared distance, SH DC
    from RGB2SH, the rest zero."""
    dev = points.device
    n = points.shape[0]
    cap = capacity or _round_capacity(int(1.5 * n))
    k = shlib.num_sh_coeffs(max_sh_degree)

    log_s = initial_log_scales(points)

    def pad(x):
        out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[:n] = x
        return out

    quats = torch.zeros(cap, 4, device=dev)
    quats[:, 0] = 1.0
    logit0 = inverse_sigmoid(torch.tensor(init_opacity, dtype=torch.float32))
    active = torch.zeros(cap, dtype=torch.bool, device=dev)
    active[:n] = True
    return GaussianField(
        means=pad(points.float()),
        quats=quats,
        log_scales=pad(log_s),
        logit_opacity=pad(torch.full((n,), float(logit0), device=dev)),
        sh_dc=pad(shlib.rgb2sh(colors.float())[:, None, :]),
        sh_rest=torch.zeros(cap, k - 1, 3, device=dev),
        active=active,
        max_radii2d=torch.zeros(cap, device=dev),
        grad_accum=torch.zeros(cap, device=dev),
        grad_denom=torch.zeros(cap, device=dev),
        scene_radius=torch.as_tensor(scene_radius, dtype=torch.float32,
                                     device=dev),
        max_sh_degree=max_sh_degree)


def from_rgbd(color: torch.Tensor, depth: torch.Tensor, cam: Camera,
              w2c: torch.Tensor, mask, max_sh_degree: int = 3,
              capacity: int | None = None) -> GaussianField:
    """First-frame init from a masked RGB-D back-projection; scene_radius =
    max(depth) / 2. color (3, H, W), depth (H, W), mask (H*W,) bool."""
    c2w = invert_se3(w2c)
    pts = backproject(depth, cam, c2w)
    cols = color.permute(1, 2, 0).reshape(-1, 3)
    m = torch.as_tensor(np.asarray(mask), dtype=torch.bool,
                        device=depth.device)
    return from_pointcloud(pts[m], cols[m], torch.max(depth) / 2.0,
                           max_sh_degree, capacity)


def grow_capacity(field: GaussianField, new_capacity: int) -> GaussianField:
    """Re-pad every per-slot tensor to a larger capacity (zeros; quats of the
    new slots get w = 1 so they stay valid rotations)."""
    assert new_capacity >= field.capacity
    extra = new_capacity - field.capacity

    def pad(x):
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    names = PARAM_NAMES + ("active", "max_radii2d", "grad_accum",
                           "grad_denom")
    padded = {k: pad(getattr(field, k)) for k in names}
    padded["quats"][field.capacity:, 0] = 1.0
    return field.replace(**padded)
