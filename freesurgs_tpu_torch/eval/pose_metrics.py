"""Trajectory evaluation: sim(3) Umeyama alignment, ATE RMSE, RPE (numpy; a
copy of ``freesurgs_tpu/eval/pose_metrics.py``, kept here so that the port
imports nothing of the JAX package).

Alignment solves gt = s R est + t over the translations; the aligned
trajectory applies R to the rotations and (s, R, t) to the translations.
ATE is the RMSE of the aligned translation errors; RPE compares
consecutive-frame relative transforms (rotation reported in degrees).
"""

from __future__ import annotations

import numpy as np


def umeyama_sim3(src: np.ndarray, dst: np.ndarray):
    """Least-squares (s, R, t) with dst ~= s * R @ src + t. (N, 3) each."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    n = src.shape[0]
    cov = (dc.T @ sc) / n
    var_src = (sc * sc).sum() / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / var_src)
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_trajectory_sim3(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Align est (N, 4, 4) to gt (N, 4, 4) with the sim3 of the
    translations: R' = R_align R_est, t' = s R_align t_est + t_align."""
    s, R, t = umeyama_sim3(est[:, :3, 3], gt[:, :3, 3])
    out = est.copy()
    out[:, :3, :3] = R[None] @ est[:, :3, :3]
    out[:, :3, 3] = (s * (R @ est[:, :3, 3].T)).T + t
    return out


def ate_rmse(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE of translation error between aligned (N, 4, 4) trajectories."""
    err = gt[:, :3, 3] - pred[:, :3, 3]
    return float(np.sqrt((np.linalg.norm(err, axis=1) ** 2).mean()))


def rpe(gt: np.ndarray, pred: np.ndarray):
    """Mean relative pose error over consecutive frames:
    (rpe_trans, rpe_rot_radians)."""
    t_errs, r_errs = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pr_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        err = np.linalg.inv(gt_rel) @ pr_rel
        t_errs.append(np.linalg.norm(err[:3, 3]))
        d = 0.5 * (np.trace(err[:3, :3]) - 1.0)
        r_errs.append(np.arccos(np.clip(d, -1.0, 1.0)))
    return float(np.mean(t_errs)), float(np.mean(r_errs))


def evaluate_poses(pred_w2c: np.ndarray, gt_poses: np.ndarray):
    """One (sub)sequence, pred_w2c and gt_poses (N, 4, 4): rpe_trans,
    rpe_rot_deg and ate."""
    pred = np.asarray(pred_w2c, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    if not np.isfinite(pred).all():
        return {"rpe_trans": float("inf"), "rpe_rot_deg": float("inf"),
                "ate": float("inf"),
                "non_finite_poses": int((~np.isfinite(pred)
                                         .all(axis=(1, 2))).sum())}
    aligned = align_trajectory_sim3(pred, gt)
    a = ate_rmse(gt, aligned)
    rt, rr = rpe(gt, aligned)
    return {"rpe_trans": rt, "rpe_rot_deg": rr * 180.0 / np.pi, "ate": a}


def evaluate_subsequences(pred_w2c: np.ndarray, gt_by_seq: dict,
                          boundaries: list[int]):
    """Metrics averaged over subsequences weighted by their frame counts."""
    total = boundaries[-1]
    acc = np.zeros(3)
    per_seq = {}
    for i, (key, gt) in enumerate(gt_by_seq.items()):
        lo, hi = boundaries[i], boundaries[i + 1]
        m = evaluate_poses(pred_w2c[lo:hi], np.asarray(gt))
        w = (hi - lo) / total
        acc += w * np.array([m["rpe_trans"], m["rpe_rot_deg"], m["ate"]])
        per_seq[key] = m
    return {"rpe_trans": acc[0], "rpe_rot_deg": acc[1], "ate": acc[2],
            "per_seq": per_seq}
