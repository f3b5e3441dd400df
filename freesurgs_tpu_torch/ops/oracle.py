"""Dense reference rasterizer (port of ``freesurgs_tpu/ops/oracle.py``).

Every pixel evaluates every Gaussian whose 16 px tile rect covers its
tile, in global front-to-back order, with the CUDA compositing cutoffs:

- alpha = min(0.99, opacity * exp(power)); skipped when power > 0 or
  alpha < 1/255;
- a pixel stops at the first Gaussian whose blend would push its
  transmittance below 1e-4, and that Gaussian is not composited;
- background is added as T_final * bg per channel.

The sequential blend is written in closed form in log-transmittance space
(``composite_order_weights``); autograd through it treats the hard cutoffs
as non-differentiable, like the CUDA backward. O(N * pixels): a test
oracle, not on the training path.
"""

from __future__ import annotations

import torch

from .projection import TILE, ProjectedGaussians

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def _order_terms(abar: torch.Tensor, dim: int, stop: bool = True,
                 linear_t: bool = False):
    """(weights, T_final, valid, crossed_incl) of the front-to-back blend of
    ``abar`` along ``dim``; crossed_incl > 0 from the stopping Gaussian on.

    The switches give the compositing-kernel ablation's functions
    (ops/raster_ablate.py): ``stop=False`` drops the T < 1e-4 stop (every
    contributing Gaussian blends); ``linear_t`` carries T as a running
    product of (1 - alpha) instead of in log space."""
    contributes = abar > 0
    if linear_t:
        one_m = 1.0 - abar
        incl = torch.cumprod(one_m, dim=dim)
        T_pre = torch.cat([torch.ones_like(incl.narrow(dim, 0, 1)),
                           incl.narrow(dim, 0, abar.shape[dim] - 1)], dim=dim)
    else:
        log1m = torch.log1p(-abar)
        cum_incl = torch.cumsum(log1m, dim=dim)
        cum_excl = cum_incl - log1m
        T_pre = torch.exp(cum_excl)
    crossed = contributes & (T_pre * (1.0 - abar) < T_EPS)
    if not stop:
        crossed = torch.zeros_like(crossed)
    crossed_incl = torch.cumsum(crossed.to(torch.int32), dim=dim)
    valid = contributes & (crossed_incl == 0)
    weights = abar * T_pre * valid
    if linear_t:
        T_final = torch.prod(torch.where(valid, one_m,
                                         torch.ones_like(one_m)), dim=dim)
    else:
        T_final = torch.exp(torch.sum(log1m * valid, dim=dim))
    return weights, T_final, valid, crossed_incl


def composite_order_weights(abar: torch.Tensor, dim: int = 0):
    """Closed-form front-to-back compositing weights along ``dim``.

    abar: effective alphas in front-to-back order (0 = skip).
    Returns (weights like abar, T_final with ``dim`` reduced).
    """
    return _order_terms(abar, dim)[:2]


def gaussian_alpha(mx, my, ca, cb, cc, opac, px, py):
    """Effective alpha (0 where a cutoff fails) of Gaussians at pixels,
    broadcast; the tile-rect mask is the caller's."""
    dx = mx - px
    dy = my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    raw = opac * torch.exp(power)
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    ok = (power <= 0) & (alpha >= ALPHA_MIN)
    return torch.where(ok, alpha, torch.zeros_like(alpha))


def rasterize_oracle(proj: ProjectedGaussians, colors: torch.Tensor,
                     opacity: torch.Tensor, height: int, width: int,
                     bg: torch.Tensor):
    """Densely rasterize N Gaussians: {"image": (C, H, W), "final_T": (H, W)}."""
    n, nch = colors.shape
    key = torch.where(proj.radius > 0, proj.depth.detach(),
                      torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    rect = proj.tile_rect[order]
    cols = colors[order]
    opac = opacity[order] * (proj.radius[order] > 0)

    dev = mean2d.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px = xs.reshape(-1).to(mean2d.dtype)
    py = ys.reshape(-1).to(mean2d.dtype)
    ptx = (xs // TILE).reshape(-1)
    pty = (ys // TILE).reshape(-1)

    abar = gaussian_alpha(mean2d[:, 0:1], mean2d[:, 1:2], conic[:, 0:1],
                          conic[:, 1:2], conic[:, 2:3], opac[:, None],
                          px[None, :], py[None, :])
    in_rect = ((ptx[None, :] >= rect[:, 0:1]) & (ptx[None, :] < rect[:, 2:3])
               & (pty[None, :] >= rect[:, 1:2]) & (pty[None, :] < rect[:, 3:4]))
    abar = torch.where(in_rect, abar, torch.zeros_like(abar))

    weights, T_final = composite_order_weights(abar)
    image = torch.einsum("np,nc->cp", weights, cols)
    image = image + T_final[None, :] * bg[:, None]
    return {"image": image.reshape(nch, height, width),
            "final_T": T_final.reshape(height, width)}
