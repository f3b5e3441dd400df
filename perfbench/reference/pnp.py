"""Plain PyTorch reference of the PnP pose init of a frame t: RANSAC PnP on
the flow matches of frame t-1's pixels against its rendered-depth cache,
as the system under test states it (the reference repository names the
branch, ``initialize_pose(pnp=True)``, but never defines its solver; the
system's stand-in for ``cv2.solvePnPRansac(..., reprojectionError=3.0)``):

- matches: frame t-1's pixels (centres at integers) whose forward flow
  target lies inside the image (0 < x < W, 0 < y < H) and whose cached
  depth is > 0; at most ``max_points`` of them, drawn without replacement
  by numpy ``default_rng(seed).choice``; each back-projected through its
  depth into camera t-1 (in float32, as the system states it), its flow
  target the observation in camera t;
- ``iterations`` minimal sets of 6 distinct matches, drawn by
  ``torch.multinomial`` over uniform weights on a CPU generator seeded
  with ``seed``;
- each set solved by a Hartley-normalized direct linear transform of the
  3x4 projection in normalized image coordinates: the right singular
  vector of the 12x12 system's smallest singular value, its 3x3 block
  projected onto the nearest rotation (the sign of the whole matrix fixed
  so that the block's determinant is positive), the translation scaled by
  the block's mean singular value;
- a match is an inlier of a hypothesis when it reprojects within
  ``reproj_px`` pixels and in front of the camera; the first hypothesis
  with the most inliers wins, and fewer than 6 inliers fail;
- ``refine_iters`` Gauss-Newton steps on the winner's inliers: the
  reprojection residuals' Jacobian in a twist applied on the left,
  each step the least-squares solution of the linearized system;
- the relative pose composes onto frame t-1's world-to-camera; a failed
  or non-finite solve keeps frame t-1's pose.

Departures from ``cv2.solvePnPRansac`` (SOLVEPNP_ITERATIVE): its minimal
solver is EPnP on 5 points where this is a DLT on 6 (which fails on a
planar set; such a hypothesis scores few inliers and loses); it stops
adaptively at confidence 0.99 where all ``iterations`` sets are scored
here; it refines by Levenberg-Marquardt where this takes plain
Gauss-Newton steps; here an inlier must also lie in front of the camera.
The system's own solver differs from this one in its arithmetic alone:
it takes the null vector from a batched ``eigh`` of A^T A and damps its
Gauss-Newton steps slightly. Everything is in float64 after the
back-projection; nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import render as R

MIN_SET = 6


def draw_matches(flow: torch.Tensor, depth: torch.Tensor, cam: R.Cam,
                 seed: int, max_points: int = 4000):
    """(points (N, 3) in camera t-1, pixels (N, 2) in camera t), float64,
    of the flow (2, H, W) t-1 -> t and frame t-1's depth (H, W)."""
    h, w = cam.height, cam.width
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=flow.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=flow.device), indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)
    u, v = x + flow[0].reshape(-1), y + flow[1].reshape(-1)
    z = depth.reshape(-1).to(torch.float32)
    ok = (u > 0) & (u < w) & (v > 0) & (v < h) & (z > 0)
    idx = np.flatnonzero(ok.cpu().numpy())
    if len(idx) > max_points:
        idx = np.random.default_rng(seed).choice(idx, max_points,
                                                 replace=False)
    sel = torch.as_tensor(idx, device=flow.device)
    zs = z[sel]
    pts = torch.stack([(x[sel] - cam.cx) / cam.fx * zs,
                       (y[sel] - cam.cy) / cam.fy * zs, zs], 1)
    pix = torch.stack([u[sel], v[sel]], 1)
    return pts.double(), pix.double()


def minimal_sets(n: int, iterations: int, seed: int) -> torch.Tensor:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.multinomial(torch.ones(iterations, n), MIN_SET,
                             replacement=False, generator=gen)


def _normalize(p: torch.Tensor):
    """A similarity of (..., k, d) points: centred, mean distance sqrt(d);
    (normalized points, centre, scale)."""
    c = p.mean(-2, keepdim=True)
    s = (p - c).norm(dim=-1).mean(-1, keepdim=True)[..., None] / \
        p.shape[-1] ** 0.5
    return (p - c) / s, c, s


def dlt(pts: torch.Tensor, xn: torch.Tensor):
    """Direct linear transform of (B, k, 3) points and their (B, k, 2)
    normalized image coordinates, k >= 6: (R (B, 3, 3), t (B, 3))."""
    P3, c3, s3 = _normalize(pts)
    p2, c2, s2 = _normalize(xn)
    B, k = pts.shape[:2]
    Xh = torch.cat([P3, torch.ones(B, k, 1, dtype=pts.dtype,
                                   device=pts.device)], -1)
    A = torch.zeros(B, 2 * k, 12, dtype=pts.dtype, device=pts.device)
    A[:, 0::2, 0:4] = Xh
    A[:, 0::2, 8:12] = -p2[..., 0:1] * Xh
    A[:, 1::2, 4:8] = Xh
    A[:, 1::2, 8:12] = -p2[..., 1:2] * Xh
    Vh = torch.linalg.svd(A, full_matrices=False).Vh
    Pn = Vh[:, -1].reshape(B, 3, 4)
    # back to the unnormalized frames: x = T2^-1 Pn T3 X
    T3 = torch.eye(4, dtype=pts.dtype, device=pts.device).repeat(B, 1, 1)
    T3[:, :3, :3] /= s3
    T3[:, :3, 3] = -c3[:, 0] / s3[:, 0]
    T2i = torch.eye(3, dtype=pts.dtype, device=pts.device).repeat(B, 1, 1)
    T2i[:, :2, :2] *= s2
    T2i[:, :2, 2] = c2[:, 0]
    P = T2i @ Pn @ T3
    P = P * torch.sign(torch.linalg.det(P[:, :, :3]))[:, None, None]
    U, S, Vh = torch.linalg.svd(P[:, :, :3])
    return U @ Vh, P[:, :, 3] / S.mean(-1, keepdim=True)


def reprojection(Rm, t, pts, pix, cam: R.Cam):
    """(squared pixel error (B, N), depth (B, N)) of N points under B
    poses."""
    pc = pts @ Rm.transpose(-1, -2) + t[:, None, :]
    z = pc[..., 2]
    zs = torch.where(z == 0, torch.ones_like(z), z)
    du = cam.fx * pc[..., 0] / zs + cam.cx - pix[:, 0]
    dv = cam.fy * pc[..., 1] / zs + cam.cy - pix[:, 1]
    return du * du + dv * dv, z


def _exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation of an axis-angle vector (float64)."""
    th = w.norm()
    K = torch.zeros(3, 3, dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
    K = K - K.T
    if float(th) < 1e-12:
        return torch.eye(3, dtype=w.dtype, device=w.device) + K
    return torch.eye(3, dtype=w.dtype, device=w.device) + \
        torch.sin(th) / th * K + (1 - torch.cos(th)) / th ** 2 * (K @ K)


def refine(Rm, t, pts, pix, cam: R.Cam, iters: int):
    """Gauss-Newton on the reprojection error, the twist on the left."""
    for _ in range(iters):
        pc = pts @ Rm.T + t
        a, b = pc[:, 0] / pc[:, 2], pc[:, 1] / pc[:, 2]
        r = torch.cat([cam.fx * a + cam.cx - pix[:, 0],
                       cam.fy * b + cam.cy - pix[:, 1]])
        iz, zero = 1.0 / pc[:, 2], torch.zeros_like(a)
        Ju = cam.fx * torch.stack([iz, zero, -a * iz, -a * b, 1 + a * a, -b],
                                  1)
        Jv = cam.fy * torch.stack([zero, iz, -b * iz, -1 - b * b, a * b, a],
                                  1)
        d = torch.linalg.lstsq(torch.cat([Ju, Jv]),
                               -r[:, None]).solution[:, 0]
        Rd = _exp(d[3:])
        Rm, t = Rd @ Rm, Rd @ t + d[:3]
    return Rm, t


def solve(pts, pix, cam: R.Cam, seed: int, *, ransac: bool = True,
          iterations: int = 100, reproj_px: float = 3.0,
          refine_iters: int = 10) -> dict:
    """RANSAC PnP: {"ok", "R", "t" (camera t-1 -> t), "inliers" (the
    winner's count), "best" (its index), "counts" (every hypothesis's)}.
    ``ransac=False``: one transform over all matches, refined over all
    (the planted fault ``pnp_no_ransac``)."""
    n = pts.shape[0]
    fail = {"ok": False, "inliers": 0, "best": -1, "counts": []}
    if n < MIN_SET:
        return fail
    xn = torch.stack([(pix[:, 0] - cam.cx) / cam.fx,
                      (pix[:, 1] - cam.cy) / cam.fy], 1)
    if ransac:
        sets = minimal_sets(n, iterations, seed).to(pts.device)
        Rs, ts = dlt(pts[sets], xn[sets])
        err2, z = reprojection(Rs, ts, pts, pix, cam)
        inl = (err2 <= reproj_px ** 2) & (z > 0)
        counts = inl.sum(1).tolist()
        best = counts.index(max(counts))
        if counts[best] < MIN_SET:
            return dict(fail, counts=counts)
        sel = inl[best]
        Rm, t = Rs[best], ts[best]
    else:
        Rs, ts = dlt(pts[None], xn[None])
        Rm, t, counts, best = Rs[0], ts[0], [n], 0
        sel = torch.ones(n, dtype=torch.bool, device=pts.device)
    Rm, t = refine(Rm, t, pts[sel], pix[sel], cam, refine_iters)
    ok = bool(torch.isfinite(Rm).all() and torch.isfinite(t).all())
    return {"ok": ok, "R": Rm, "t": t, "inliers": counts[best],
            "best": best, "counts": counts}


def pose_init(prev_w2c: torch.Tensor, flow: torch.Tensor,
              depth: torch.Tensor, cam: R.Cam, seed: int, *,
              ransac: bool = True, max_points: int = 4000) -> dict:
    """Frame t's world-to-camera (4, 4) float64 from frame t-1's
    ``prev_w2c``, the flow t-1 -> t and frame t-1's depth cache, with the
    solve's readings: {"w2c", "ok", "inliers", "best", "counts",
    "matches"}."""
    pts, pix = draw_matches(flow, depth, cam, seed, max_points)
    res = solve(pts, pix, cam, seed, ransac=ransac)
    prev = prev_w2c.to(torch.float64)
    out = {k: res[k] for k in ("ok", "inliers", "best", "counts")}
    out["matches"] = pts.shape[0]
    if not res["ok"]:
        out["w2c"] = prev.clone()
        return out
    rel = torch.eye(4, dtype=torch.float64, device=prev.device)
    rel[:3, :3], rel[:3, 3] = res["R"], res["t"]
    out["w2c"] = rel @ prev
    return out
