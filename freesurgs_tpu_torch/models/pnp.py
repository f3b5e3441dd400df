"""RANSAC PnP on the device: the port's counterpart of
``cv2.solvePnPRansac(..., SOLVEPNP_ITERATIVE, reprojectionError=3.0)``,
which the JAX package's ``pnp_pose_init`` calls on the host.

Given 3D points X_i in one camera frame and their pixels y_i in another,
find the rigid (R, t) with K (R X_i + t) ~ y_i while ignoring outliers:

 1. ``iterations`` minimal sets of 6 matches, drawn from a CPU
    ``torch.Generator`` seeded by the caller (so the CPU and the card draw
    the same sets), each solved by a normalized 6-point DLT of the
    projection matrix in normalized image coordinates, its 3x3 block
    projected onto the nearest rotation (sign fixed by the determinant);
    all hypotheses in one batched pass (the 12x12 null vectors by one
    batched ``eigh``);
 2. every hypothesis scored on every match in one (B, N) pass: inliers
    reproject within ``reproj_px`` pixels in front of the camera; the
    hypothesis with the most inliers wins (the first on a tie);
 3. Gauss-Newton on the winner's inliers (unweighted reprojection error,
    left-multiplied twist updates, light Levenberg damping), then the
    inliers of the refined pose.

It fails (``ok`` False) when the best hypothesis has fewer than 6 inliers
or the refined pose is not finite. Everything runs in float64; the only
host reads are the best inlier count and the finiteness test.

Differences from cv2 (whose minimal solver is EPnP on 5 points, with an
adaptive iteration count up to 100 at confidence 0.99 and a
Levenberg-Marquardt refine): a DLT needs 6 points and fails on a planar
minimal set (such a hypothesis scores few inliers and loses); all
``iterations`` hypotheses are always evaluated. The results agree with
cv2's within the tolerance of the tests, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..train.flow_pnp import so3_exp

MIN_SET = 6


class PnPResult(NamedTuple):
    ok: bool
    R: torch.Tensor          # (3, 3) float64, camera a -> camera b
    t: torch.Tensor          # (3,) float64
    inliers: torch.Tensor    # (N,) bool, of the returned pose


def _sample_sets(n: int, iterations: int, seed: int) -> torch.Tensor:
    """(iterations, 6) distinct match indices per set, from a CPU
    generator seeded by ``seed``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    weights = torch.ones(iterations, n)
    return torch.multinomial(weights, MIN_SET, replacement=False,
                             generator=gen)


def _normalizer(p: torch.Tensor):
    """Similarity that centres (B, k, d) points and scales their mean
    distance to sqrt(d): (centre (B, d), scale (B,))."""
    c = p.mean(dim=1)
    dist = torch.linalg.norm(p - c[:, None, :], dim=2).mean(dim=1)
    s = dist / (p.shape[2] ** 0.5)
    return c, torch.clamp_min(s, 1e-12)


def dlt_hypotheses(X: torch.Tensor, xn: torch.Tensor):
    """Batched 6-point DLT. X (B, 6, 3) points, xn (B, 6, 2) normalized
    image coordinates. Returns (R (B, 3, 3), t (B, 3))."""
    B = X.shape[0]
    c3, s3 = _normalizer(X)
    c2, s2 = _normalizer(xn)
    Xq = (X - c3[:, None, :]) / s3[:, None, None]
    xq = (xn - c2[:, None, :]) / s2[:, None, None]
    Xh = torch.cat([Xq, torch.ones_like(Xq[..., :1])], dim=2)   # (B, 6, 4)
    zero = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zero, -xq[..., 0:1] * Xh], dim=2)
    rows_v = torch.cat([zero, Xh, -xq[..., 1:2] * Xh], dim=2)
    A = torch.cat([rows_u, rows_v], dim=1)                      # (B, 12, 12)
    _, vecs = torch.linalg.eigh(A.transpose(1, 2) @ A)
    Pq = vecs[:, :, 0].reshape(B, 3, 4)
    # undo the normalizations: P = T2^-1 Pq T3
    T3 = torch.zeros(B, 4, 4, dtype=X.dtype, device=X.device)
    T3[:, :3, :3] = torch.eye(3, dtype=X.dtype, device=X.device) \
        / s3[:, None, None]
    T3[:, :3, 3] = -c3 / s3[:, None]
    T3[:, 3, 3] = 1.0
    T2inv = torch.zeros(B, 3, 3, dtype=X.dtype, device=X.device)
    T2inv[:, 0, 0] = s2
    T2inv[:, 1, 1] = s2
    T2inv[:, :2, 2] = c2
    T2inv[:, 2, 2] = 1.0
    P = T2inv @ Pq @ T3
    M = P[:, :, :3]
    sign = torch.where(torch.linalg.det(M) < 0, -1.0, 1.0).to(X.dtype)
    P = P * sign[:, None, None]
    U, S, Vh = torch.linalg.svd(P[:, :, :3])
    R = U @ Vh
    t = P[:, :, 3] / torch.clamp_min(S.mean(dim=1), 1e-300)[:, None]
    return R, t


def reprojection_sq(R, t, X, img, K):
    """Squared pixel error (B, N) and depth (B, N) of N points under B
    poses (R (B, 3, 3), t (B, 3))."""
    pc = torch.einsum("bij,nj->bni", R, X) + t[:, None, :]
    z = pc[..., 2]
    zs = torch.where(z.abs() > 1e-12, z, torch.ones_like(z))
    u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
    return (u - img[:, 0]) ** 2 + (v - img[:, 1]) ** 2, z


def gauss_newton(R, t, X, img, K, iters: int = 10, damping: float = 1e-6):
    """Least-squares reprojection refine of one pose on matches X (N, 3),
    img (N, 2): Gauss-Newton with left-multiplied twist updates."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        p = X @ R.T + t
        z = p[:, 2]
        zs = torch.where(z.abs() > 1e-12, z, torch.ones_like(z))
        a = p[:, 0] / zs
        b = p[:, 1] / zs
        r = torch.stack([fx * a + cx - img[:, 0], fy * b + cy - img[:, 1]], 1)
        zero = torch.zeros_like(zs)
        Ju = torch.stack([fx / zs, zero, -fx / zs * a, -fx * a * b,
                          fx * (1.0 + a * a), -fx * b], dim=1)
        Jv = torch.stack([zero, fy / zs, -fy / zs * b, -fy * (1.0 + b * b),
                          fy * a * b, fy * a], dim=1)
        H = Ju.T @ Ju + Jv.T @ Jv
        g = Ju.T @ r[:, 0] + Jv.T @ r[:, 1]
        H = H + damping * torch.diag(torch.diag(H)) + 1e-12 * eye6
        delta = -torch.linalg.solve_ex(H, g)[0]
        Rd = so3_exp(delta[3:])
        R = Rd @ R
        t = Rd @ t + delta[:3]
    return R, t


def solve_pnp_ransac(obj: torch.Tensor, img: torch.Tensor, K: torch.Tensor,
                     *, reproj_px: float = 3.0, iterations: int = 100,
                     refine_iters: int = 10, seed: int = 0) -> PnPResult:
    """RANSAC PnP of matches obj (N, 3) (points in camera a) and img (N, 2)
    (their pixels in camera b) under intrinsics K (3, 3); all on the
    device of ``obj``, in float64. Returns a ``PnPResult``; R, t map
    camera-a coordinates to camera b."""
    with torch.no_grad():
        X = obj.to(torch.float64)
        y = img.to(torch.float64)
        K = K.to(device=X.device, dtype=torch.float64)
        n = X.shape[0]
        eye = torch.eye(3, dtype=X.dtype, device=X.device)
        if n < MIN_SET:
            return PnPResult(False, eye, torch.zeros(3, dtype=X.dtype,
                                                     device=X.device),
                             torch.zeros(n, dtype=torch.bool,
                                         device=X.device))
        sets = _sample_sets(n, iterations, seed).to(X.device)
        xn = torch.stack([(y[:, 0] - K[0, 2]) / K[0, 0],
                          (y[:, 1] - K[1, 2]) / K[1, 1]], dim=1)
        Rs, ts = dlt_hypotheses(X[sets], xn[sets])
        err2, z = reprojection_sq(Rs, ts, X, y, K)
        inl = (err2 <= reproj_px * reproj_px) & (z > 0)
        counts = inl.sum(dim=1)
        best = torch.argmax(counts)
        if int(counts[best]) < MIN_SET:
            return PnPResult(False, eye, torch.zeros(3, dtype=X.dtype,
                                                     device=X.device),
                             inl[best])
        sel = inl[best]
        R, t = gauss_newton(Rs[best], ts[best], X[sel], y[sel], K,
                            iters=refine_iters)
        ok = bool(torch.isfinite(R).all() & torch.isfinite(t).all())
        err2, z = reprojection_sq(R[None], t[None], X, y, K)
        inliers = ((err2[0] <= reproj_px * reproj_px) & (z[0] > 0))
        return PnPResult(ok, R, t, inliers)
