"""Dense optical flow by multi-scale Horn-Schunck, and a parallax disparity
proxy (port of ``freesurgs_tpu/data/flow_hs.py``).

The producers that turn raw frames into the ``flow/`` and ``monodep/``
inputs the loader reads (``cli/produce_inputs.py``); the reference ships
none and assumes precomputed RAFT files. Coarse to fine over a pyramid: at
each level the current flow warps the target frame (bilinear, clamped at
the border), a linearized Horn-Schunck system is solved by Jacobi sweeps
(4-neighbour smoothness) and the increment is added, ``n_warps`` times.

Plain PyTorch ops, on the device of the inputs. Every function takes any
leading batch dimensions, so a caller can solve a frame pair's forward and
backward flow in one pass: the arithmetic per element is the same, and so
are the results. At the defaults (5 levels x 3 warps x 60 sweeps) a flow
field is ~10^4 small launches, bound by the host's launch rate on the
card.

Kept from the JAX package: the target's centred gradients wrap around the
border (``torch.roll``, as its ``jnp.roll``), although its comment says
border-replicated; and the median of ``parallax_disparity`` averages the
two middle values of an even count, as ``jnp.median`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) in [0, 1] -> (..., H, W) luma."""
    r, g, b = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x box downsample of (..., H, W), an odd side cropped to even."""
    h, w = img.shape[-2:]
    img = img[..., : h - h % 2, : w - w % 2]
    return 0.25 * (img[..., 0::2, 0::2] + img[..., 1::2, 0::2]
                   + img[..., 0::2, 1::2] + img[..., 1::2, 1::2])


def _bilinear(img: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) at float coords of the same shape, clamped to the
    border."""
    h, w = img.shape[-2:]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1, h * w)

    def tap(yi, xi):
        return flat.gather(1, (yi * w + xi).reshape(flat.shape[0], -1)
                           ).reshape(x.shape)

    v00, v01 = tap(y0, x0), tap(y0, x1)
    v10, v11 = tap(y1, x0), tap(y1, x1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _neighbor_avg(f: torch.Tensor) -> torch.Tensor:
    """4-neighbour average of (..., H, W) with edge replication (the
    smoothness term)."""
    h, w = f.shape[-2:]
    p = F.pad(f.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate")
    p = p.reshape(f.shape[:-2] + (h + 2, w + 2))
    up = p[..., :-2, 1:-1]
    dn = p[..., 2:, 1:-1]
    lf = p[..., 1:-1, :-2]
    rt = p[..., 1:-1, 2:]
    return 0.25 * (up + dn + lf + rt)


def _grid(h: int, w: int, like: torch.Tensor):
    ys = torch.arange(h, dtype=torch.float32, device=like.device)
    xs = torch.arange(w, dtype=torch.float32, device=like.device)
    return torch.meshgrid(ys, xs, indexing="ij")


def _hs_level(i0, i1, u, v, alpha, n_warps: int, n_jacobi: int):
    """One pyramid level: warp, linearize, Jacobi sweeps; ``n_warps`` times.
    i0, i1, u, v (..., H, W); alpha a f32 scalar tensor."""
    h, w = i0.shape[-2:]
    yy, xx = _grid(h, w, i0)
    for _ in range(n_warps):
        i1w = _bilinear(i1, xx + u, yy + v)
        # centred gradients of the warped target; torch.roll wraps around
        # the border exactly as the JAX package's jnp.roll does
        gx = 0.5 * (torch.roll(i1w, -1, -1) - torch.roll(i1w, 1, -1))
        gy = 0.5 * (torch.roll(i1w, -1, -2) - torch.roll(i1w, 1, -2))
        it = i1w - i0
        denom = alpha * alpha + gx * gx + gy * gy
        # u and v sweep together, stacked as (2, ..., H, W): the same
        # per-element arithmetic as two separate sweeps, half the launches
        g = torch.stack([gx, gy])
        uv = torch.stack([u, v])
        duv = torch.zeros_like(uv)
        for _ in range(n_jacobi):
            bar = _neighbor_avg(uv + duv) - uv
            t = (gx * bar[0] + gy * bar[1] + it) / denom
            duv = bar - g * t
        u, v = u + duv[0], v + duv[1]
    return u, v


def _upsample2_to(f: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Upsample a flow component (..., H', W') -> (..., h, w), scaling
    magnitudes by 2."""
    hh, ww = f.shape[-2:]
    ys = torch.arange(h, dtype=torch.int32, device=f.device)
    xs = torch.arange(w, dtype=torch.int32, device=f.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    sx = ww / w
    sy = hh / h
    shape = f.shape[:-2] + (h, w)
    x = ((xx + 0.5) * sx - 0.5).expand(shape)
    y = ((yy + 0.5) * sy - 0.5).expand(shape)
    return 2.0 * _bilinear(f, x, y)


def hs_flow(img0: torch.Tensor, img1: torch.Tensor, levels: int = 5,
            alpha: float = 0.3, n_warps: int = 3,
            n_jacobi: int = 60) -> torch.Tensor:
    """Dense flow img0 -> img1. Inputs (..., 3, H, W) in [0, 1]; returns
    (..., 2, H, W) float32 (dx, dy) in pixels, the RAFT ``pred`` convention
    the loader reads."""
    with torch.no_grad():
        g0 = _to_gray(img0.to(torch.float32))
        g1 = _to_gray(img1.to(torch.float32))
        pyr = [(g0, g1)]
        for _ in range(levels - 1):
            g0 = _downsample2(g0)
            g1 = _downsample2(g1)
            pyr.append((g0, g1))
        a = torch.tensor(alpha, dtype=torch.float32, device=g0.device)
        u = torch.zeros_like(pyr[-1][0])
        v = torch.zeros_like(pyr[-1][0])
        for l0, l1 in reversed(pyr):
            h, w = l0.shape[-2:]
            if u.shape[-2:] != (h, w):
                u = _upsample2_to(u, h, w)
                v = _upsample2_to(v, h, w)
            u, v = _hs_level(l0, l1, u, v, a, n_warps, n_jacobi)
        return torch.stack([u, v], dim=-3)


def _median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim as ``jnp.median``: the mean of the two
    middle values when the count is even (``torch.median`` would return
    the lower one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def parallax_disparity(flow_fw: torch.Tensor,
                       flow_bw: torch.Tensor) -> torch.Tensor:
    """Median-compensated parallax magnitude, a monocular structure proxy.

    For translation-dominant video the flow left after removing its global
    median (a stand-in for the rotational part) is proportional to inverse
    depth; the loader min-max normalizes 1/disp, so only the relative
    structure matters. |fw| and |bw| are averaged. Inputs (..., 2, H, W);
    output (..., H, W) > 0 in the ``pred`` disparity convention."""
    def residual(f):
        med = _median_midpoint(f.reshape(f.shape[:-2] + (-1,)))
        r = f - med[..., None, None]
        return torch.sqrt(r[..., 0, :, :] * r[..., 0, :, :]
                          + r[..., 1, :, :] * r[..., 1, :, :] + 1e-12)

    with torch.no_grad():
        mag = 0.5 * (residual(flow_fw.to(torch.float32))
                     + residual(flow_bw.to(torch.float32)))
        # light smoothing: disparity priors are low-frequency
        for _ in range(2):
            mag = _neighbor_avg(mag)
        peak = torch.amax(mag, dim=(-2, -1), keepdim=True)
        return mag + 1e-3 * peak
