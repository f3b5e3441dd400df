"""Image quality metrics: PSNR / SSIM / LPIPS (port of
``freesurgs_tpu/eval/image_metrics.py``), on (T, 3, H, W) numpy stacks.

- PSNR: mean over frames of -10 log10(per-frame MSE);
- SSIM: skimage's ``structural_similarity`` semantics (uniform 7x7 window,
  sample covariance, crop-to-valid mean, channel average), on scipy;
- LPIPS: AlexNet v0.1 (``eval/lpips.py``) with exported weights when they
  exist, else the fixed-seed random-feature trunk. ``lpips_backend`` says
  which; random-feature values are for trends only.
"""

from __future__ import annotations

import numpy as np

from .lpips import load_weights, lpips_alex, random_weights


def psnr(gts: np.ndarray, preds: np.ndarray) -> float:
    """(T, 3, H, W) in [0, 1]."""
    gts = np.asarray(gts, np.float32)
    preds = np.asarray(preds, np.float32)
    mse = ((gts - preds) ** 2).mean(axis=(1, 2, 3))
    return float((-10.0 * np.log10(np.maximum(mse, 1e-12))).mean())


def _ssim_skimage_single(a: np.ndarray, b: np.ndarray,
                         data_range: float = 1.0, win: int = 7) -> float:
    """skimage.metrics.structural_similarity on one (H, W) channel: uniform
    window, sample covariance normalization N / (N - 1), crop-to-valid
    mean."""
    from scipy.ndimage import uniform_filter
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    ndw = win * win
    cov_norm = ndw / (ndw - 1)
    ux = uniform_filter(a, win)
    uy = uniform_filter(b, win)
    uxx = uniform_filter(a * a, win)
    uyy = uniform_filter(b * b, win)
    uxy = uniform_filter(a * b, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = (((2 * ux * uy + c1) * (2 * vxy + c2))
                / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    pad = (win - 1) // 2
    return float(ssim_map[pad:-pad, pad:-pad].mean())


def ssim_metric(gts: np.ndarray, preds: np.ndarray) -> float:
    """Mean over frames of the channel-averaged SSIM."""
    vals = [np.mean([_ssim_skimage_single(g[c], p[c])
                     for c in range(g.shape[0])])
            for g, p in zip(gts, preds)]
    return float(np.mean(vals))


def lpips_metric(gts: np.ndarray, preds: np.ndarray,
                 device="cuda") -> tuple[float, str]:
    """AlexNet LPIPS v0.1: (value, backend), backend "weights" with the
    exported weights, else "random_features"."""
    w = load_weights()
    if w is not None:
        return lpips_alex(gts, preds, w, device=device), "weights"
    return (lpips_alex(gts, preds, random_weights(), device=device),
            "random_features")


def rgb_evaluation(gts: np.ndarray, preds: np.ndarray,
                   device="cuda") -> dict:
    """psnr, ssim, lpips and lpips_backend over (T, 3, H, W) stacks in
    [0, 1]; LPIPS runs on ``device``."""
    gts = np.clip(np.asarray(gts, np.float32), 0.0, 1.0)
    preds = np.clip(np.asarray(preds, np.float32), 0.0, 1.0)
    lp, backend = lpips_metric(gts, preds, device=device)
    return {"psnr": psnr(gts, preds), "ssim": ssim_metric(gts, preds),
            "lpips": lp, "lpips_backend": backend}
