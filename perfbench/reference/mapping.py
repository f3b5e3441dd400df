"""Plain PyTorch reference of Free-SurGS's mapping iteration: render one
view, the mapping loss, its gradients and the Adam update.

The loss is the reference training script's (wrld/Free-SurGS ``train.py``):

  5.0 * (0.8 L1 + 0.2 (1 - SSIM))(render, frame)
  + 0.05 * (1 - Pearson)(depth prior, rendered depth)
  + 0.15 * mean over random 128 px boxes of (1 - Pearson) in each box,

SSIM with an 11-tap Gaussian window (sigma 1.5), zero SAME padding, C1 =
0.01^2, C2 = 0.03^2; the Pearson terms in the smooth form x / sqrt(var +
1e-12). The update is Adam (beta 0.9 / 0.999, eps 1e-15, one shared step
count, bias correction 1 - beta^t) with the learning rate of each group
from the configuration; the means' decays log-linearly to its final value
at ``position_lr_max_steps``. A non-finite gradient entry counts as 0.

``initial_map`` builds the map a job starts from (frame 0's RGB-D init).
``follow`` runs the reference from a given state through a given schedule
of frames, boxes and rebins. ``precision`` picks the arithmetic: "fp32"
(TF32 off everywhere) or "tf32" (the control: matrix products and
convolutions in TF32); ``drop_half_rows`` is a planted fault for the
checks of the comparison: the photometric loss over the top half of the
rows only.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import render as R

LEAVES = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
          "sh_rest")
BOX = 128


@contextlib.contextmanager
def precision(mode: str):
    """Matmuls and convolutions in full f32 ("fp32") or TF32 ("tf32") while
    the block runs; the previous flags come back after it."""
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"precision {mode!r}: 'fp32' or 'tf32'")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _band(n: int, device) -> torch.Tensor:
    """(n, n) matrix B with (x @ B)[i] = sum_k w[k] x[i + k - 5], rows
    outside [0, n) left out (zero padding); w the 11-tap Gaussian."""
    x = np.arange(11) - 5
    w = np.exp(-(x ** 2) / (2.0 * 1.5 ** 2))
    w = (w / w.sum()).astype(np.float32)
    B = np.zeros((n, n), np.float32)
    for j in range(11):
        off = j - 5
        idx = np.arange(max(0, -off), min(n, n - off))
        B[idx + off, idx] = w[j]
    return torch.from_numpy(B).to(device)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images."""
    _, h, w = a.shape
    Bw, Bh = _band(w, a.device), _band(h, a.device)
    x = torch.cat([a, b, a * a, b * b, a * b], 0)
    x = Bh.T @ (x @ Bw)
    c = a.shape[0]
    mu1, mu2 = x[:c], x[c:2 * c]
    s1 = x[2 * c:3 * c] - mu1 * mu1
    s2 = x[3 * c:4 * c] - mu2 * mu2
    s12 = x[4 * c:] - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    return torch.mean(num / den)


def _pearson_loss(s, t, dims):
    s = s - s.mean(dim=dims, keepdim=True)
    t = t - t.mean(dim=dims, keepdim=True)
    vs = (s * s).mean(dim=dims)
    vt = (t * t).mean(dim=dims)
    return 1.0 - (s * t).mean(dim=dims) * torch.rsqrt(
        (vs + 1e-12) * (vt + 1e-12))


def mapping_loss(rgb, depth, frame, prior, boxes, cfg: dict,
                 drop_half_rows: bool = False):
    """(total, [photometric, Pearson, local Pearson] weighted) of one view;
    ``boxes`` the (row, column) corners of the local-Pearson boxes."""
    if drop_half_rows:
        half = rgb.shape[1] // 2
        rgb, frame = rgb[:, :half], frame[:, :half]
    photo = 0.8 * torch.mean(torch.abs(rgb - frame)) + \
        0.2 * (1.0 - ssim(rgb, frame))
    pear = _pearson_loss(prior, depth, (0, 1))
    box = min(BOX, *depth.shape)
    r = torch.arange(box, device=depth.device)
    rows = (boxes[0][:, None] + r)[:, :, None]
    cols = (boxes[1][:, None] + r)[:, None, :]
    local = torch.mean(_pearson_loss(prior[rows, cols], depth[rows, cols],
                                     (1, 2)))
    terms = torch.stack([cfg["w_rgb_mapping"] * photo,
                         cfg["w_pearson"] * pear,
                         cfg["w_local_pearson"] * local])
    return terms.sum(), terms


def box_corners(h: int, w: int, gen: torch.Generator, device):
    """The loss's random boxes (128 px, or the image's shorter side): half
    as many as fit in a grid, corners drawn uniformly (rows, then columns)
    from ``gen``."""
    box = min(BOX, h, w)
    n = max(int(0.5 * (h // box) * (w // box)), 1)
    x0 = torch.randint(0, max(h - box, 1), (n,), generator=gen)
    y0 = torch.randint(0, max(w - box, 1), (n,), generator=gen)
    return x0.to(device), y0.to(device)


def mean_sq_dist_3nn(pts: torch.Tensor, block: int = 512) -> torch.Tensor:
    """(N,) mean squared distance of each point to its 3 nearest others,
    by brute force over coordinate differences, ``block`` points at a
    time."""
    n = pts.shape[0]
    out = torch.empty(n, device=pts.device)
    for i in range(0, n, block):
        q = pts[i:i + block]
        d2 = sum((q[:, None, j] - pts[None, :, j]) ** 2 for j in range(3))
        b = torch.arange(q.shape[0], device=pts.device)
        d2[b, b + i] = math.inf
        out[i:i + block] = torch.topk(d2, 3, dim=1, largest=False
                                      ).values.mean(dim=1)
    return out


def initial_map(seq, frac: float, seed: int, sh_degree: int) -> dict:
    """The map a job starts from (the reference's ``create_random_mask``
    and RGB-D init): ``frac`` of frame 0's pixels, kept by a permutation
    drawn from ``seed``, back-projected through the depth prior (pixel
    centres at integers) into the world by frame 0's pose; colours as SH
    DC, the rest 0; identity rotations; opacity 0.1; each scale the root of
    the mean squared distance to the 3 nearest points (at least 1e-7)."""
    cam = seq.cam
    h, w = cam.height, cam.width
    dev = seq.colors.device
    k = int(frac * h * w)
    keep = np.sort(np.random.default_rng(seed).permutation(h * w)[:k])
    idx = torch.from_numpy(keep).to(dev)
    ys, xs = idx // w, idx % w
    z = seq.prior[0].reshape(-1)[idx]
    pc = torch.stack([(xs.float() - cam.cx) / cam.fx * z,
                      (ys.float() - cam.cy) / cam.fy * z, z], -1)
    w2c = seq.w2c[0]
    means = (pc - w2c[:3, 3]) @ w2c[:3, :3]
    rgb = seq.colors[0].reshape(3, -1)[:, idx].T
    d2 = torch.clamp_min(mean_sq_dist_3nn(means), 1e-7)
    quats = torch.zeros(k, 4, device=dev)
    quats[:, 0] = 1.0
    return {"means": means, "quats": quats,
            "log_scales": (0.5 * torch.log(d2))[:, None].repeat(1, 3),
            "logit_opacity": torch.full((k,), math.log(0.1 / 0.9),
                                        device=dev),
            "sh_dc": ((rgb - 0.5) / R.SH_C0)[:, None, :],
            "sh_rest": torch.zeros(k, (sh_degree + 1) ** 2 - 1, 3,
                                   device=dev)}


def learning_rates(cfg: dict, step: int) -> dict:
    t = min(max(step / cfg["position_lr_max_steps"], 0.0), 1.0)
    li = math.log(cfg["position_lr_init"] * cfg["spatial_lr_scale"])
    lf = math.log(cfg["position_lr_final"] * cfg["spatial_lr_scale"])
    return {"means": math.exp(li * (1 - t) + lf * t),
            "quats": cfg["rotation_lr"], "log_scales": cfg["scaling_lr"],
            "logit_opacity": cfg["opacity_lr"], "sh_dc": cfg["feature_lr"],
            "sh_rest": cfg["feature_lr"] / 20.0}


def adam(params, grads, mu, nu, count, lrs):
    """One Adam step: (params, mu, nu, count) after it."""
    count += 1
    bc1 = 1.0 - 0.9 ** count
    bc2 = 1.0 - 0.999 ** count
    out_p, out_m, out_v = {}, {}, {}
    for k in LEAVES:
        g = grads[k]
        m = 0.9 * mu[k] + 0.1 * g
        v = 0.999 * nu[k] + 0.001 * g * g
        out_p[k] = params[k] - lrs[k] * (m / bc1) / (torch.sqrt(v / bc2)
                                                     + 1e-15)
        out_m[k], out_v[k] = m, v
    return out_p, out_m, out_v, count


def step_grads(params, active, w2c, cam: R.Cam, sh_degree, frame, prior,
               boxes, cfg, carry=None, drop_half_rows=False):
    """Render one view, its loss and the gradients of every leaf. Returns
    (loss, grads, the carry of this render)."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    with torch.enable_grad():
        p, lay, out, carry = R.render(leaves, active, w2c, cam, sh_degree,
                                      carry)
        img = out["image"].requires_grad_(True)
        loss, _ = mapping_loss(img[0:3], img[3], frame, prior, boxes, cfg,
                               drop_half_rows)
        (g_img,) = torch.autograd.grad(loss, (img,))
        dfeat = R.composite_backward(p, lay, cam, g_img)
        feats = R._features(p)
        gs = torch.autograd.grad(feats, [leaves[k] for k in LEAVES], dfeat,
                                 allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else
             torch.where(torch.isfinite(g), g, torch.zeros_like(g))
             for k, g in zip(LEAVES, gs)}
    return loss.detach(), grads, carry


def follow(state: dict, schedule: list, seq, cam: R.Cam, cfg: dict, *,
           mode: str = "fp32", drop_half_rows: bool = False) -> dict:
    """Run mapping iterations from ``state`` (params, active, mu, nu,
    count, iteration, sh_degree) over ``schedule``, a list of (frame,
    rebin, boxes). ``seq`` gives colors / prior / w2c by frame. Returns the
    losses, the first iteration's gradients, and the parameters after."""
    params = {k: state["params"][k].clone() for k in LEAVES}
    mu = {k: v.clone() for k, v in state["mu"].items()}
    nu = {k: v.clone() for k, v in state["nu"].items()}
    count, it = state["count"], state["iteration"]
    losses, first = [], None
    carry = None
    with precision(mode):
        for frame, rebin, boxes in schedule:
            if rebin:
                carry = None
            loss, grads, carry = step_grads(
                params, state["active"], seq.w2c[frame], cam,
                state["sh_degree"], seq.colors[frame], seq.prior[frame],
                boxes, cfg, carry, drop_half_rows)
            it += 1
            params, mu, nu, count = adam(params, grads, mu, nu, count,
                                         learning_rates(cfg, it))
            losses.append(float(loss))
            if first is None:
                first = grads
    return {"losses": losses, "grad1": first, "params": params}
