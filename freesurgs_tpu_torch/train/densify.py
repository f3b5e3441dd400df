"""Densification and pruning at fixed capacity
(port of ``freesurgs_tpu/train/densify.py``).

The reference's clone / split / prune semantics as masked writes into the
slot pool:

- clone: grad >= thresh and max_scale <= 0.01 * scene_radius -> copy into a
  free slot (original kept);
- split: grad >= thresh and max_scale > 0.01 * scene_radius -> two children
  at N(0, scale) offsets rotated into the world frame, scale / 1.6;
  original pruned;
- prune: opacity < min_opacity, or (size gate on) world scale >
  0.1 * scene_radius; the reference's radii2D prune is dead code there and
  off here;
- moments of created and pruned slots are zeroed.

Children that do not fit in free slots are dropped and counted. The split
noise is an argument (standard normal, (2, C, 3)), drawn by the caller
from its ``torch.Generator`` (``split_noise``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.transforms import quat_to_rotmat
from ..models.gaussians import PARAM_NAMES, GaussianField, inverse_sigmoid
from .optim import AdamState, surgery_mask_moments


class DensifyConfig(NamedTuple):
    grad_threshold: float = 2e-4
    min_opacity: float = 0.05
    percent_dense: float = 0.01
    prune_scale_frac: float = 0.1
    # The reference's screen-size prune is dead code there (max_radii2D is
    # zeroed before the mask is taken); False keeps its effective semantics.
    prune_radii2d: bool = False
    max_screen_size: float = 20.0


class DensifyStats(NamedTuple):
    cloned: torch.Tensor
    split: torch.Tensor
    pruned: torch.Tensor
    pruned_opacity: torch.Tensor
    pruned_world: torch.Tensor
    pruned_screen: torch.Tensor
    dropped: torch.Tensor
    num_active: torch.Tensor


def split_noise(capacity: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """The (2, C, 3) standard-normal draw ``densify_and_prune`` consumes,
    from a CPU generator (the same numbers on every device)."""
    return torch.randn((2, capacity, 3), generator=generator).to(device)


def densify_and_prune(field: GaussianField, opt_state: AdamState,
                      noise: torch.Tensor, cfg: DensifyConfig,
                      use_screen_size: bool
                      ) -> tuple[GaussianField, AdamState, DensifyStats]:
    """One densify+prune event; ``use_screen_size`` gates the world-size
    prune (the reference turns it on after iteration 4000)."""
    c = field.capacity
    dev = field.means.device
    act = field.active
    grads = torch.where(field.grad_denom > 0,
                        field.grad_accum / torch.clamp_min(field.grad_denom,
                                                           1.0),
                        torch.zeros_like(field.grad_accum))
    scales = torch.exp(field.log_scales)
    max_scale = torch.max(scales, dim=1).values
    opacity = torch.sigmoid(field.logit_opacity)
    pivot = cfg.percent_dense * field.scene_radius

    hot = act & (grads >= cfg.grad_threshold)
    clone_m = hot & (max_scale <= pivot)
    split_m = hot & (max_scale > pivot)

    prune_op = act & (opacity < cfg.min_opacity)
    prune_world = act & (max_scale > cfg.prune_scale_frac
                         * field.scene_radius) & bool(use_screen_size)
    if cfg.prune_radii2d:
        prune_screen = (act & (field.max_radii2d > cfg.max_screen_size)
                        & bool(use_screen_size))
    else:
        prune_screen = torch.zeros_like(prune_op)
    prune_m = prune_op | prune_world | prune_screen | split_m

    # children over a 3C-wide virtual list [clone | split0 | split1], ranked
    # jointly against the C free slots in slot order
    free = ~act | prune_m
    want3 = torch.cat([clone_m, split_m, split_m])
    free_slots = torch.nonzero(free).flatten()
    n_free = free_slots.shape[0]
    want_rank = torch.cumsum(want3.to(torch.int64), 0) - 1
    placed3 = want3 & (want_rank < n_free)
    src3 = torch.arange(3 * c, device=dev) % c
    dest = free_slots[want_rank[placed3]]
    src = src3[placed3]

    R = quat_to_rotmat(field.quats)
    offs = torch.einsum("cij,kcj->kci", R, noise * scales[None])  # (2, C, 3)
    child_means = torch.cat([field.means, field.means + offs[0],
                             field.means + offs[1]])
    split_log_scales = field.log_scales - torch.log(torch.tensor(
        0.8 * 2.0, dtype=torch.float32, device=dev))
    child_log_scales = torch.cat([field.log_scales, split_log_scales,
                                  split_log_scales])

    new_params = {}
    for k in PARAM_NAMES:
        x = getattr(field, k).clone()
        if k == "means":
            x[dest] = child_means[placed3]
        elif k == "log_scales":
            x[dest] = child_log_scales[placed3]
        else:
            x[dest] = getattr(field, k)[src]
        new_params[k] = x
    new_active = act & ~prune_m
    new_active[dest] = True

    field = field.replace(active=new_active, **new_params).reset_stats()

    created = torch.zeros(c, dtype=torch.bool, device=dev)
    created[dest] = True
    opt_state = surgery_mask_moments(opt_state, created | prune_m)

    stats = DensifyStats(
        cloned=clone_m.sum(), split=split_m.sum(),
        pruned=(prune_m & ~split_m).sum(),
        pruned_opacity=prune_op.sum(), pruned_world=prune_world.sum(),
        pruned_screen=prune_screen.sum(),
        dropped=want3.sum() - placed3.sum(),
        num_active=new_active.sum())
    return field, opt_state, stats


def reset_opacity(field: GaussianField, opt_state: AdamState,
                  ceiling: float = 0.01) -> tuple[GaussianField, AdamState]:
    """Clamp active opacities to <= ceiling and zero the opacity moments."""
    op = torch.sigmoid(field.logit_opacity)
    new_logit = inverse_sigmoid(torch.clamp(op, max=ceiling))
    field = field.replace(logit_opacity=torch.where(
        field.active, new_logit, field.logit_opacity))
    mu = dict(opt_state.mu)
    nu = dict(opt_state.nu)
    mu["logit_opacity"] = torch.zeros_like(mu["logit_opacity"])
    nu["logit_opacity"] = torch.zeros_like(nu["logit_opacity"])
    return field, AdamState(mu=mu, nu=nu, count=opt_state.count)


def add_render_stats(field: GaussianField, probe_grad: torch.Tensor,
                     radii: torch.Tensor, visibility: torch.Tensor,
                     grad_scale: torch.Tensor | None = None
                     ) -> GaussianField:
    """Accumulate per-view densify statistics. ``grad_scale`` (0.5 W,
    0.5 H) converts the pixel-space probe gradient to the half-NDC units
    the reference's 2e-4 threshold is calibrated in."""
    vis = visibility & field.active
    if grad_scale is not None:
        probe_grad = probe_grad * grad_scale
    gnorm = torch.linalg.norm(probe_grad, dim=-1)
    zero = torch.zeros_like(gnorm)
    return field.replace(
        grad_accum=field.grad_accum + torch.where(vis, gnorm, zero),
        grad_denom=field.grad_denom + vis.to(torch.float32),
        max_radii2d=torch.where(vis, torch.maximum(field.max_radii2d,
                                                   radii.to(torch.float32)),
                                field.max_radii2d))
