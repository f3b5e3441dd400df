"""High-level differentiable renderer (port of ``freesurgs_tpu/ops/render.py``).

One compositing pass yields [r, g, b, z, sil, z^2] and T_final. Kept from
the reference:

- SH view directions from the frame-0 camera center (the origin), with
  the NaN-safe ``x * rsqrt(max(|x|^2, 1e-16))`` normalize (never-used
  capacity slots hold exactly zero means);
- a white background composited into ALL six channels, so depth, silhouette
  and depth^2 each get + T_final;
- covariances not rotated into the camera frame.

Pose gradients flow through the world->camera transform with autograd;
``gs_grad`` / ``cam_grad`` detach the Gaussians or the pose. ``probe2d`` is
a zero tensor added to the projected means whose gradient is the
screen-space densify statistic.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.camera import Camera
from ..core.sh import sh_to_rgb_clamped
from ..core.transforms import transform_points
from ..utils.profiling import span
from .binning import TileBins
from .projection import TILE, project_gaussians
from .raster_cuda import RasterConfig, instance_records, rasterize

# Instance-buffer cap used when the caller names none (the JAX package's
# TrainConfig.max_instances_cap).
DEFAULT_MAX_INSTANCES = 3_145_728


def raster_config(cam: Camera, max_instances: int = 0,
                  grad_sum: str = "direct") -> RasterConfig:
    return RasterConfig(height=cam.height, width=cam.width,
                        max_instances=max_instances or DEFAULT_MAX_INSTANCES,
                        grad_sum=grad_sum)


def _raster_inputs(means_w, quats, log_scales, logit_opacity, sh_coeffs,
                   w2c, cam, active, probe2d, sh_degree):
    """Project the field for ``rasterize``: (proj, rgbz (N, 4), opacity)."""
    with span("project"):
        mean_cam = transform_points(w2c, means_w)
        opacity = torch.sigmoid(logit_opacity)
        proj = project_gaussians(mean_cam, torch.exp(log_scales), quats, cam,
                                 active=active)
        if probe2d is not None:
            proj = proj._replace(mean2d=proj.mean2d + probe2d)

        # SH -> RGB against the origin; rsqrt(max(|x|^2, eps^2)) keeps the
        # gradient of exactly-zero (unused) means at 0 instead of 0 * inf.
        n2 = torch.sum(means_w * means_w, dim=-1, keepdim=True)
        dirs = means_w * torch.rsqrt(torch.clamp_min(n2, 1e-16))
        rgb = sh_to_rgb_clamped(sh_degree, sh_coeffs, dirs)
        return proj, torch.cat([rgb, proj.depth[:, None]], dim=1), opacity


def render_records(means3d, quats, log_scales, logit_opacity, sh_coeffs,
                   w2c, cam: Camera, *, active=None, sh_degree: int = 0,
                   max_instances: int = 0, grad_sum: str = "direct"):
    """The binned records ``render`` would hand the compositing kernels for
    this view, without autograd: (RasterConfig, feat (10, M), rect (M,),
    TileBins). For checking and timing the kernels on a real layout."""
    with torch.no_grad():
        proj, rgbz, opacity = _raster_inputs(
            means3d, quats, log_scales, logit_opacity, sh_coeffs, w2c, cam,
            active, None, sh_degree)
        cfg = raster_config(cam, max_instances, grad_sum)
        return (cfg,) + instance_records(proj, rgbz, opacity, cfg)


def render(means3d: torch.Tensor, quats: torch.Tensor,
           log_scales: torch.Tensor, logit_opacity: torch.Tensor,
           sh_coeffs: torch.Tensor, w2c: torch.Tensor, cam: Camera, *,
           active: torch.Tensor | None = None,
           probe2d: torch.Tensor | None = None,
           sh_degree: int = 0,
           bg: torch.Tensor | None = None,
           max_instances: int = 0,
           gs_grad: bool = True,
           cam_grad: bool = True,
           bins: TileBins | None = None,
           rebin: bool | None = None,
           grad_sum: str = "direct") -> dict[str, Any]:
    """Render a view of the Gaussian field.

    means3d (N, 3), quats (N, 4) unnormalized (w, x, y, z), log_scales
    (N, 3), logit_opacity (N,), sh_coeffs (N, K, 3), w2c (4, 4).
    Compositing runs the CUDA kernels on a CUDA tensor and their plain
    versions on a CPU tensor (ops/raster_cuda.py).
    max_instances: cap on the instance buffer (0 -> DEFAULT_MAX_INSTANCES).
    bins / rebin: the binning-layout carry (ops/raster_cuda.py, "the layout
    carry"). ``rebin`` None renders without one; True bins fresh (``bins``
    may be None, the start of a carry); False reuses ``bins``. With a
    carry the result holds "bins", the layout used, for the caller to
    carry on (JAX ``render(bins=, rebin=)``, with a host bool for the
    traced one). grad_sum: the backward's per-Gaussian reduction,
    "direct" or "prefix" (the JAX default's; ``raster_cuda.RasterConfig``).

    Returns render (3, H, W), render_dep, render_sil, presence_mask,
    uncertainty, final_T, render_w2c, radii, visibility, overflow
    (instances dropped at the cap; 0 below it) and num_instances.
    """
    if rebin is None and bins is not None:
        raise ValueError("a bins carry needs a rebin flag")
    if rebin is False and bins is None:
        raise ValueError("rebin=False needs a layout to reuse")
    if bg is None:
        bg = torch.ones(3, dtype=means3d.dtype, device=means3d.device)

    w2c_used = w2c if cam_grad else w2c.detach()

    def gs(x):
        return x if gs_grad else x.detach()

    proj, rgbz, opacity = _raster_inputs(
        gs(means3d), gs(quats), gs(log_scales), gs(logit_opacity),
        gs(sh_coeffs), w2c_used, cam, active, probe2d, sh_degree)
    with span("raster"):
        bg6 = torch.cat([bg, torch.ones(3, dtype=bg.dtype,
                                        device=bg.device)])
        out = rasterize(proj, rgbz, opacity,
                        raster_config(cam, max_instances, grad_sum),
                        bins=None if rebin else bins)
        final_T = out["final_T"]
        image6 = out["image"] + final_T[None] * bg6[:, None, None]

        depth = image6[3]
        sil = image6[4]
        depth_sq = image6[5]
        extra = {} if rebin is None else {"bins": out["bins"]}
        return {
            **extra,
            "render": image6[0:3],
            "render_dep": depth,
            "render_sil": sil,
            "presence_mask": sil > 0.3,
            "uncertainty": (depth_sq - depth * depth).detach(),
            "final_T": final_T,
            "render_w2c": w2c_used,
            "radii": proj.radius,
            "visibility": proj.radius > 0,
            "overflow": out["overflow"],
            "num_instances": out["num_instances"],
        }


def grid_dims(cam: Camera) -> tuple[int, int]:
    """The camera's 16 px tile grid, (columns, rows)."""
    return -(-cam.width // TILE), -(-cam.height // TILE)
