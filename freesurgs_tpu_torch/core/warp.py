"""Flow warping and occlusion checking (port of ``freesurgs_tpu/core/warp.py``).

A bilinear backward warp with zero padding outside the image (the
reference's ``torch_warp``, ``grid_sample(padding_mode='zeros')``), the
forward-backward flow consistency check, and the median of valid depths.
Differentiable.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample (C, H, W) at float pixel coords x, y (any shape); each of the
    four taps reads 0 outside the image."""
    _, H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yi = torch.clamp(yi, 0, H - 1).to(torch.int64)
        v = img[:, yi, xi]
        return torch.where(inside, v, torch.zeros_like(v))

    return (tap(x0, y0) * (1 - wx) * (1 - wy)
            + tap(x0 + 1, y0) * wx * (1 - wy)
            + tap(x0, y0 + 1) * (1 - wx) * wy
            + tap(x0 + 1, y0 + 1) * wx * wy)


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp a (C, H, W) image by a (2, H, W) flow:
    out(p) = img(p + flow)."""
    _, H, W = img.shape
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return bilinear_sample(img, xx + flow[0], yy + flow[1])


def forward_backward_occlusion(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                               alpha1: float = 0.01, alpha2: float = 0.5):
    """(H, W) bool, True where forward and backward flow agree:
    |fw + warp(bw, fw)|^2 < alpha1 (|fw|^2 + |warp(bw, fw)|^2) + alpha2."""
    bw_at_fw = flow_warp(flow_bw, flow_fw)
    diff = flow_fw + bw_at_fw
    mag = torch.sum(flow_fw ** 2, 0) + torch.sum(bw_at_fw ** 2, 0)
    return torch.sum(diff ** 2, 0) < alpha1 * mag + alpha2


def median_depth(depth: torch.Tensor, opacity: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None,
                 opacity_thresh: float = 0.95) -> torch.Tensor:
    """The reference's ``get_median_depth``: the sorted valid depths
    (invalid ones pushed to +inf) read at index max(n // 2 - 1, 0), n the
    number of valid depths; +inf when none is valid."""
    valid = depth > 0
    if opacity is not None:
        valid = valid & (opacity > opacity_thresh)
    if mask is not None:
        valid = valid & mask
    vals = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    srt = torch.sort(vals.reshape(-1)).values
    n = valid.sum()
    return srt[torch.clamp_min(torch.div(n, 2, rounding_mode="floor") - 1, 0)]
