"""Training losses (port of ``freesurgs_tpu/train/losses.py``).

- rgb_loss: 0.8 L1 + 0.2 (1 - SSIM), optional multiplicative mask;
- pearson / local-pearson monocular-depth regularizers;
- flow-reprojection loss for tracking, with validity masking;
- the MiDaS-style scale-and-shift-invariant depth loss.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera, backproject, pixel_grid, project
from ..core.transforms import invert_se3, transform_points
from ..ops.ssim import ssim


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def rgb_loss(img, gt, mask=None, lambda_dssim: float = 0.2):
    """(C, H, W) photometric loss; the mask multiplies both images and the
    means stay over all pixels (reference semantics)."""
    if mask is not None:
        m = mask.to(img.dtype)
        if m.ndim == 2:
            m = m[None]
        img = img * m
        gt = gt * m
    return (1.0 - lambda_dssim) * l1(img, gt) + lambda_dssim * (
        1.0 - ssim(img, gt))


def pearson_depth_loss(src, target, eps: float = 1e-6):
    """1 - Pearson correlation, in the smooth form x / sqrt(var + eps^2)
    whose gradient stays finite on a constant map (std + eps is 0/0 there)."""
    s = src - torch.mean(src)
    t = target - torch.mean(target)
    vs = torch.mean(s * s)
    vt = torch.mean(t * t)
    co = torch.mean(s * t) * torch.rsqrt((vs + eps * eps) * (vt + eps * eps))
    return 1.0 - co


def local_pearson_boxes(h: int, w: int, generator: torch.Generator,
                        box: int = 128, p_corr: float = 0.5,
                        device=None):
    """Draw the random box corners of ``local_pearson_loss`` from a CPU
    generator: (x0, y0) int tensors on ``device`` of p_corr * (H//box) *
    (W//box) boxes (at least one)."""
    box = min(box, h, w)
    n_boxes = max(int(p_corr * (h // box) * (w // box)), 1)
    x0 = torch.randint(0, max(h - box, 1), (n_boxes,), generator=generator)
    y0 = torch.randint(0, max(w - box, 1), (n_boxes,), generator=generator)
    return x0.to(device), y0.to(device)


def local_pearson_loss(src, target, x0, y0, box: int = 128):
    """Mean Pearson-depth loss over boxes at rows x0 / columns y0 (drawn by
    ``local_pearson_boxes``); the draw is separate so callers can feed any
    corners."""
    h, w = src.shape
    box = min(box, h, w)
    r = torch.arange(box, device=src.device)
    rows = (x0[:, None] + r)[:, :, None]
    cols = (y0[:, None] + r)[:, None, :]
    s = src[rows, cols]                        # (n_boxes, box, box)
    t = target[rows, cols]
    s = s - s.mean(dim=(1, 2), keepdim=True)
    t = t - t.mean(dim=(1, 2), keepdim=True)
    vs = (s * s).mean(dim=(1, 2))
    vt = (t * t).mean(dim=(1, 2))
    eps = 1e-6
    co = (s * t).mean(dim=(1, 2)) * torch.rsqrt((vs + eps * eps)
                                                * (vt + eps * eps))
    return torch.mean(1.0 - co)


def flow_projection_loss(prev_depth, prev_w2c, cur_w2c, gt_flow_fw,
                         cam: Camera, rigid_mask=None, edge: int = 20):
    """Reproject the previous frame's rendered depth through (prev pose)^-1
    and the current (differentiable) pose; masked mean L1 against the
    precomputed forward flow over valid pixels x 2 components.

    The back-projection runs in the cache's own dtype, as in the JAX
    package: a bf16 cache gets a bf16 pixel grid, coarser than a pixel past
    x = 256 (kept for parity; ROADMAP Queue 3)."""
    H, W = cam.height, cam.width
    depth_mask = prev_depth > 0
    if rigid_mask is not None:
        depth_mask = depth_mask & (rigid_mask > 0)

    c2w_prev = invert_se3(prev_w2c)
    pts_world = backproject(prev_depth, cam, c2w_prev)
    pts_cur = transform_points(cur_w2c, pts_world)
    proj, z = project(pts_cur, cam)

    xg, yg = pixel_grid(H, W, device=prev_depth.device)
    pix = torch.stack([xg.reshape(-1), yg.reshape(-1)], dim=1)
    induced = proj - pix
    gt = torch.stack([gt_flow_fw[0].reshape(-1),
                      gt_flow_fw[1].reshape(-1)], dim=1)

    valid = (depth_mask.reshape(-1)
             & (proj[:, 0] > edge) & (proj[:, 0] < W - edge)
             & (proj[:, 1] > edge) & (proj[:, 1] < H - edge)
             & (z > 0))
    vf = valid.to(induced.dtype)[:, None]
    # select before multiplying: invalid pixels may project to +/-inf
    diff = torch.where(vf > 0, induced - gt, torch.zeros_like(induced))
    num = torch.sum(torch.abs(diff))
    den = 2.0 * torch.sum(vf) + 1e-8
    loss = num / den
    return torch.where(torch.sum(vf) > 0, loss, torch.zeros_like(loss))


def compute_scale_and_shift(prediction, target, mask):
    """Least-squares (scale, shift) with target ~ s*pred + t over masked
    pixels. Shapes (B, H, W); returns (B,), (B,)."""
    a00 = torch.sum(mask * prediction * prediction, (1, 2))
    a01 = torch.sum(mask * prediction, (1, 2))
    a11 = torch.sum(mask, (1, 2))
    b0 = torch.sum(mask * prediction * target, (1, 2))
    b1 = torch.sum(mask * target, (1, 2))
    det = a00 * a11 - a01 * a01
    ok = det != 0
    det_safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    s = torch.where(ok, (a11 * b0 - a01 * b1) / det_safe, zero)
    t = torch.where(ok, (-a01 * b0 + a00 * b1) / det_safe, zero)
    return s, t


def _masked_gradient_loss(diff, mask):
    gx = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * (
        mask[:, :, 1:] * mask[:, :, :-1])
    gy = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * (
        mask[:, 1:, :] * mask[:, :-1, :])
    return torch.sum(gx, (1, 2)) + torch.sum(gy, (1, 2))


def scale_shift_invariant_loss(prediction, target, mask, scales: int = 4):
    """Multi-scale gradient-matching loss on the scale/shift-aligned
    prediction (the reference's alpha=1 configuration)."""
    s, t = compute_scale_and_shift(prediction, target, mask)
    pred = s[:, None, None] * prediction + t[:, None, None]
    total = prediction.new_zeros(())
    denom = prediction.new_zeros(())
    for sc in range(scales):
        step = 2 ** sc
        m = mask[:, ::step, ::step]
        d = (pred - target)[:, ::step, ::step] * m
        total = total + torch.sum(_masked_gradient_loss(d, m))
        denom = denom + torch.sum(m)
    return torch.where(denom > 0, total / torch.clamp_min(denom, 1.0),
                       torch.zeros_like(total))
