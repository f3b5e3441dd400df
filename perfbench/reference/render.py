"""Plain PyTorch rendering of a 3D Gaussian field: projection, depth order
per 16 px tile and front-to-back compositing, forward and backward.

The semantics are those of the 3D Gaussian Splatting rasterizer that
Free-SurGS trains with (arXiv:2308.04079, its CUDA ``preprocess`` and
``render`` kernels), as the system under test states them:

- means move into the camera frame; covariances are built from the
  normalized quaternion and the scales and are NOT rotated into it; the
  EWA Jacobian clamps x/z to 1.3 tan(fov) and the 2D covariance gets +0.3;
- pixel centres sit at integers: ``pix = f x / z + c - 0.5``;
- a Gaussian is culled at z <= 0.2, det <= 0 or an empty tile rect; its
  16 px tile rect is the kernel's ``getRect`` with the radius
  ceil(3 sqrt(lambda_max)), lambda_max = mid + sqrt(max(mid^2 - det, 0.1));
- alpha = min(0.99, opacity exp(power)), skipped where power > 0 or
  alpha < 1/255; a pixel stops at the first Gaussian whose blend would take
  its transmittance below 1e-4, which is not blended;
- channels [r, g, b, z, 1, z^2] are blended, and the white background adds
  T_final to all six; colours are SH of the direction from the origin,
  +0.5, clamped at 0.

A render may reuse the coverage and depth order of an earlier one (the
layout carry of a training loop that rebins every few iterations): each
Gaussian then composites only in the 32 px bins its pruned, alpha-snug
coverage touched at that earlier render, in that render's depth order,
with its current values.

Everything is in float32; ``mapping.precision`` sets TF32 off (or, for
the control, on). Compositing runs tile batch by tile batch with bounded
memory;
the backward recomputes each batch under autograd from the image
cotangents. Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import torch

TILE = 16
BIN = 32
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR = 0.2
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
# Elements of one (tiles x pixels x slots) temporary of a tile batch.
BATCH_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Cam:
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def grid(self) -> tuple[int, int]:
        """16 px tiles (columns, rows)."""
        return -(-self.width // TILE), -(-self.height // TILE)


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z), normalized here -> (..., 3, 3)."""
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True),
                            1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def sh_rgb(sh: torch.Tensor, dirs: torch.Tensor, degree: int
           ) -> torch.Tensor:
    """Real SH up to ``degree`` (<= 3) of (N, K, 3) coefficients at unit
    directions (N, 3), +0.5, clamped at 0."""
    v = SH_C0 * sh[:, 0]
    if degree > 0:
        x, y, z = (dirs[:, i:i + 1] for i in range(3))
        v = v - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            v = (v + SH_C2[0] * x * y * sh[:, 4] + SH_C2[1] * y * z * sh[:, 5]
                 + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
                 + SH_C2[3] * x * z * sh[:, 7]
                 + SH_C2[4] * (xx - yy) * sh[:, 8])
            if degree > 2:
                v = (v + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
                     + SH_C3[1] * x * y * z * sh[:, 10]
                     + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
                     + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
                     + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
                     + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                     + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    v = v + 0.5
    return torch.maximum(v, torch.zeros_like(v))


def _trunc_i64(x: torch.Tensor) -> torch.Tensor:
    """Float -> integer toward zero, NaN -> 0, clipped to +/-1e9."""
    return torch.nan_to_num(x, nan=0.0).clamp(-1e9, 1e9).to(torch.int64)


def project(means, quats, log_scales, logit_opacity, sh, active, w2c,
            cam: Cam, sh_degree: int) -> dict:
    """Per-Gaussian screen quantities, differentiable in the parameters:
    mean2d (N, 2), conic (N, 3), opacity, rgb (N, 3), depth (N,), and,
    without gradients, the 16 px tile rect (N, 4) int64 (x0, y0, x1, y1,
    half-open; empty when culled)."""
    R, t = w2c[:3, :3], w2c[:3, 3]
    mc = means @ R.T + t
    x, y, z = mc.unbind(-1)
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    px = cam.fx * x / zs + cam.cx - 0.5
    py = cam.fy * y / zs + cam.cy - 0.5

    M = quat_rotmat(quats) * torch.exp(log_scales)[:, None, :]
    cov = M @ M.transpose(-1, -2)
    zj = torch.where(z == 0, torch.full_like(z, 1e-6), z)
    limx = 1.3 * cam.width / (2.0 * cam.fx)
    limy = 1.3 * cam.height / (2.0 * cam.fy)
    xc = torch.clamp(x / zj, -limx, limx) * zj
    yc = torch.clamp(y / zj, -limy, limy) * zj
    j00, j02 = cam.fx / zj, -cam.fx * xc / (zj * zj)
    j11, j12 = cam.fy / zj, -cam.fy * yc / (zj * zj)
    s00, s01, s02 = cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2]
    s11, s12, s22 = cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]
    a0, a1, a2 = j00 * s00 + j02 * s02, j00 * s01 + j02 * s12, \
        j00 * s02 + j02 * s22
    b1, b2 = j11 * s11 + j12 * s12, j11 * s12 + j12 * s22
    ca = a0 * j00 + a2 * j02 + 0.3
    cb = a1 * j11 + a2 * j12
    cc = b1 * j11 + b2 * j12 + 0.3
    det = ca * cc - cb * cb
    dsafe = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([cc / dsafe, -cb / dsafe, ca / dsafe], -1)

    opacity = torch.sigmoid(logit_opacity)
    n2 = torch.sum(means * means, -1, keepdim=True)
    dirs = means * torch.rsqrt(torch.clamp_min(n2, 1e-16))
    rgb = sh_rgb(sh, dirs, sh_degree)

    with torch.no_grad():
        mid = 0.5 * (ca + cc)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        r = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
        gx, gy = cam.grid
        rect = torch.stack([
            _trunc_i64((px - r) / TILE).clamp(0, gx),
            _trunc_i64((py - r) / TILE).clamp(0, gy),
            _trunc_i64((px + r + TILE - 1) / TILE).clamp(0, gx),
            _trunc_i64((py + r + TILE - 1) / TILE).clamp(0, gy)], -1)
        vis = ((z > NEAR) & (det > 0) & active & (rect[:, 2] > rect[:, 0])
               & (rect[:, 3] > rect[:, 1]))
        rect = torch.where(vis[:, None], rect, torch.zeros_like(rect))
    return {"mean2d": torch.stack([px, py], -1), "conic": conic,
            "opacity": opacity, "rgb": rgb, "depth": z, "rect": rect,
            "visible": vis}


def _support_box(p: dict, margin: float) -> torch.Tensor:
    """(N, 4) float pixel box of {alpha >= 1/255} (+margin px): the
    ellipse power >= -log(255 opacity)."""
    A, B, C = p["conic"].detach().unbind(-1)
    det = torch.clamp_min(A * C - B * B, 1e-24)
    t2 = 2.0 * torch.log(torch.clamp_min(255.0 * p["opacity"].detach(), 1.0))
    rx = torch.sqrt(t2 * C / det) + margin
    ry = torch.sqrt(t2 * A / det) + margin
    m = p["mean2d"].detach()
    return torch.stack([m[:, 0] - rx, m[:, 1] - ry, m[:, 0] + rx,
                        m[:, 1] + ry], -1)


def coverage(p: dict) -> torch.Tensor:
    """(N, 4) int64 16 px tiles a Gaussian can composite in: its rect,
    cut to the tiles its alpha >= 1/255 box (+1 px) reaches; empty for
    opacity below 1/255."""
    with torch.no_grad():
        box = _support_box(p, 1.0)
        r = p["rect"]
        lo = torch.floor(box[:, 0:2] / TILE)
        hi = torch.floor(box[:, 2:4] / TILE) + 1
        x0 = torch.maximum(r[:, 0], _trunc_i64(torch.clamp_min(lo[:, 0], -1)))
        y0 = torch.maximum(r[:, 1], _trunc_i64(torch.clamp_min(lo[:, 1], -1)))
        x1 = torch.minimum(r[:, 2], _trunc_i64(torch.clamp_min(hi[:, 0], -1)))
        y1 = torch.minimum(r[:, 3], _trunc_i64(torch.clamp_min(hi[:, 1], -1)))
        on = (p["visible"] & (p["opacity"].detach() >= ALPHA_MIN)
              & (x1 > x0) & (y1 > y0))
        cov = torch.stack([x0, y0, x1, y1], -1)
        return torch.where(on[:, None], cov, torch.zeros_like(cov))


def carried_bins(p: dict) -> torch.Tensor:
    """(N, 4) int64 32 px bins of a binning render that later renders
    reuse: the rect pruned at opacity < 1/255 and snugged to the alpha box
    with +0.5 px, each bound truncated to a 16 px tile, then coarsened."""
    with torch.no_grad():
        box = _support_box(p, 0.5)
        r = p["rect"]
        x0 = torch.maximum(r[:, 0], _trunc_i64(box[:, 0] / TILE))
        y0 = torch.maximum(r[:, 1], _trunc_i64(box[:, 1] / TILE))
        x1 = torch.minimum(r[:, 2], _trunc_i64(box[:, 2] / TILE) + 1)
        y1 = torch.minimum(r[:, 3], _trunc_i64(box[:, 3] / TILE) + 1)
        on = (p["visible"] & (p["opacity"].detach() >= ALPHA_MIN)
              & (x1 > x0) & (y1 > y0))
        s = BIN // TILE
        b = torch.stack([torch.div(x0, s, rounding_mode="floor"),
                         torch.div(y0, s, rounding_mode="floor"),
                         -torch.div(-x1, s, rounding_mode="floor"),
                         -torch.div(-y1, s, rounding_mode="floor")], -1)
        return torch.where(on[:, None], b, torch.zeros_like(b))


@dataclasses.dataclass
class Layout:
    """Depth-ordered instance lists per 16 px tile: ``gauss`` (I,) sorted
    by (tile, depth, index), ``start`` / ``count`` (tiles,)."""
    gauss: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor


def build_layout(cov: torch.Tensor, depth_key: torch.Tensor, cam: Cam,
                 bins: torch.Tensor | None = None) -> Layout:
    """Expand each Gaussian over its covered tiles (``cov``, (N, 4)),
    keeping with ``bins`` only the tiles inside its carried 32 px bins,
    and order every tile's list front to back by ``depth_key``."""
    dev = cov.device
    gx, gy = cam.grid
    n = cov.shape[0]
    if bins is not None:
        s = BIN // TILE
        cov = torch.stack([torch.maximum(cov[:, 0], bins[:, 0] * s),
                           torch.maximum(cov[:, 1], bins[:, 1] * s),
                           torch.minimum(cov[:, 2], bins[:, 2] * s),
                           torch.minimum(cov[:, 3], bins[:, 3] * s)], -1)
    w = torch.clamp_min(cov[:, 2] - cov[:, 0], 0)
    h = torch.clamp_min(cov[:, 3] - cov[:, 1], 0)
    cnt = w * h
    g = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    local = torch.arange(g.shape[0], device=dev) - \
        (torch.cumsum(cnt, 0) - cnt)[g]
    wg = torch.clamp_min(w[g], 1)
    tile = (cov[g, 1] + torch.div(local, wg, rounding_mode="floor")) * gx \
        + cov[g, 0] + local % wg
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(depth_key, stable=True)] = torch.arange(n, device=dev)
    order = torch.argsort(tile * n + rank[g])
    gauss = g[order]
    count = torch.bincount(tile, minlength=gx * gy)
    start = torch.cumsum(count, 0) - count
    return Layout(gauss=gauss, start=start, count=count)


def _batches(count: torch.Tensor, budget: int):
    """Non-empty tiles, longest list first, grouped so that a batch's
    padded tiles x pixels x slots stays within ``budget``."""
    cnt = count.tolist()
    order = sorted((t for t, c in enumerate(cnt) if c > 0),
                   key=lambda t: -cnt[t])
    batch: list[int] = []
    for t in order:
        if batch and (len(batch) + 1) * cnt[batch[0]] * TILE * TILE > budget:
            yield batch
            batch = []
        batch.append(t)
    if batch:
        yield batch


def _pixel_xy(tl: torch.Tensor, gx: int, dtype):
    p = torch.arange(TILE * TILE, device=tl.device)
    ix = (tl % gx)[:, None] * TILE + p % TILE
    iy = torch.div(tl, gx, rounding_mode="floor")[:, None] * TILE + \
        torch.div(p, TILE, rounding_mode="floor")
    return ix.to(dtype), iy.to(dtype)


def _composite(feat: torch.Tensor, ok: torch.Tensor, tl: torch.Tensor,
               cam: Cam):
    """Blend a batch: feat (B, L, 10) [mx, my, ca, cb, cc, opacity, r, g, b,
    z] front to back, ok (B, L) real slots. Returns (img (B, 6, 256),
    T_final (B, 256), pairs: blended (B, 256, L) bool, stopped (B, 256)
    bool)."""
    ix, iy = _pixel_xy(tl, cam.grid[0], feat.dtype)
    inside = ((ix < cam.width) & (iy < cam.height))[:, :, None]
    f = feat[:, None]                                   # (B, 1, L, 10)
    dx = f[..., 0] - ix[:, :, None]
    dy = f[..., 1] - iy[:, :, None]
    power = -0.5 * (f[..., 2] * dx * dx + f[..., 4] * dy * dy) \
        - f[..., 3] * dx * dy
    # power > 0 is never blended; the clamp keeps its exp finite for the
    # backward's masked products
    alpha = torch.clamp(f[..., 5] * torch.exp(torch.clamp_max(power, 0.0)),
                        max=ALPHA_MAX)
    use = (power <= 0) & (alpha >= ALPHA_MIN) & ok[:, None, :] & inside
    alpha = torch.where(use, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    cum = torch.cumsum(log1m, -1)
    t_pre = torch.exp(cum - log1m)
    cross = use & (t_pre * (1.0 - alpha) < T_EPS)
    blended = use & (torch.cumsum(cross.to(torch.int32), -1) == 0)
    w = alpha * t_pre * blended
    z = feat[..., 9]
    cols = torch.stack([feat[..., 6], feat[..., 7], feat[..., 8], z,
                        torch.ones_like(z), z * z], -1)    # (B, L, 6)
    img = torch.einsum("bpl,blc->bcp", w, cols)
    t_fin = torch.exp(torch.sum(log1m * blended, -1))
    return img, t_fin, blended, cross.any(-1)


def _features(p: dict) -> torch.Tensor:
    return torch.cat([p["mean2d"], p["conic"], p["opacity"][:, None],
                      p["rgb"], p["depth"][:, None]], 1)


def _batch_index(lay: Layout, tiles, dev):
    tl = torch.as_tensor(tiles, device=dev)
    cnt = lay.count[tl]
    L = int(cnt.max())
    j = torch.arange(L, device=dev)
    ok = j[None, :] < cnt[:, None]
    idx = torch.where(ok, lay.start[tl][:, None] + j, torch.zeros_like(j))
    return tl, ok, lay.gauss[idx]


def _tile_view(img: torch.Tensor, cam: Cam) -> torch.Tensor:
    gx, gy = cam.grid
    c = img.shape[0]
    return img.view(c, gy, TILE, gx, TILE).permute(1, 3, 0, 2, 4)


def composite(p: dict, lay: Layout, cam: Cam,
              budget: int = BATCH_ELEMS) -> dict:
    """Forward compositing without autograd: image (6, H, W) with the
    background in every channel, T_final (H, W), and the pair counts
    ``blended`` / ``stopped`` (the work this render needs)."""
    gx, gy = cam.grid
    dev = p["depth"].device
    with torch.no_grad():
        feat = _features(p)
        out = torch.zeros(7, gy * TILE, gx * TILE, device=dev)
        out[6] = 1.0
        view = _tile_view(out, cam)
        n_blend = n_stop = 0
        for tiles in _batches(lay.count, budget):
            tl, ok, gi = _batch_index(lay, tiles, dev)
            img, tf, blended, stopped = _composite(feat[gi], ok, tl, cam)
            vals = torch.cat([img, tf[:, None]], 1)
            view[torch.div(tl, gx, rounding_mode="floor"), tl % gx] = \
                vals.view(-1, 7, TILE, TILE)
            n_blend += int(blended.sum())
            n_stop += int(stopped.sum())
        out = out[:, :cam.height, :cam.width]
        image = out[:6] + out[6][None]
    return {"image": image, "final_T": out[6], "blended": n_blend,
            "stopped": n_stop}


def composite_backward(p: dict, lay: Layout, cam: Cam, g_image: torch.Tensor,
                       budget: int = BATCH_ELEMS) -> torch.Tensor:
    """Cotangent of the per-Gaussian features (N, 10) from the cotangent of
    ``composite``'s image (6, H, W), each tile batch recomputed under
    autograd (the background's T_final carries the channels' sum)."""
    gx, gy = cam.grid
    dev = g_image.device
    feat = _features(p).detach()
    g = torch.zeros(7, gy * TILE, gx * TILE, device=dev)
    g[:6, :cam.height, :cam.width] = g_image
    g[6, :cam.height, :cam.width] = g_image.sum(0)
    gview = _tile_view(g, cam)
    dfeat = torch.zeros_like(feat)
    for tiles in _batches(lay.count, budget):
        tl, ok, gi = _batch_index(lay, tiles, dev)
        fb = feat[gi].requires_grad_(True)
        with torch.enable_grad():
            img, tf, _, _ = _composite(fb, ok, tl, cam)
            gb = gview[torch.div(tl, gx, rounding_mode="floor"),
                       tl % gx].reshape(len(tiles), 7, TILE * TILE)
            (d,) = torch.autograd.grad((img, tf), (fb,),
                                       (gb[:, :6], gb[:, 6]))
        dfeat.index_add_(0, gi[ok], d[ok])
    return dfeat


def render(params: dict, active, w2c, cam: Cam, sh_degree: int,
           carry: dict | None = None, budget: int = BATCH_ELEMS):
    """Project and composite one view (forward only). ``carry``: the
    ``bins`` and ``depth`` of an earlier binning render to reuse. Returns
    (projection, layout, composite result, this render's carry)."""
    sh = torch.cat([params["sh_dc"], params["sh_rest"]], 1)
    p = project(params["means"], params["quats"], params["log_scales"],
                params["logit_opacity"], sh, active, w2c, cam, sh_degree)
    cov = coverage(p)
    if carry is None:
        carry = {"bins": carried_bins(p), "depth": torch.where(
            p["visible"], p["depth"].detach(),
            torch.full_like(p["depth"], math.inf))}
        lay = build_layout(cov, carry["depth"], cam)
    else:
        lay = build_layout(cov, carry["depth"], cam, carry["bins"])
    return p, lay, composite(p, lay, cam, budget), carry
