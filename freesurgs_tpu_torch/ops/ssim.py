"""SSIM with an 11x11 Gaussian window, in f32 (port of ``freesurgs_tpu/ops/ssim.py``).

Matches the reference's training-loss SSIM: sigma 1.5, window 11, SAME
zero padding, C1 = 0.01^2, C2 = 0.03^2, mean over the map.

The separable blur is a banded-matrix product, ``blur_axis(x) = x @ B``
with B the (n, n) 11-diagonal Gaussian band, as in the JAX module. It must
run in full f32: the variance terms E[x^2] - mu^2 cancel to the scale of
C2 = 9e-4, and operand truncation (bf16 on the TPU, TF32 on the card) lets
the SSIM denominator cross zero. ``torch.matmul`` in f32 is full precision
unless ``torch.backends.cuda.matmul.allow_tf32`` is set, so ``ssim``
refuses to run with it set rather than lose the contract silently.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=4)
def _gauss_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, device: str, window_size: int = 11,
                 sigma: float = 1.5) -> torch.Tensor:
    """(n, n) banded correlation matrix: (x @ B)[i] = sum_k w[k] *
    x[i + k - half], rows outside [0, n) dropped == SAME zero padding."""
    w = _gauss_window(window_size, sigma)
    B = np.zeros((n, n), np.float32)
    half = window_size // 2
    for j in range(window_size):
        off = j - half
        idx = np.arange(max(0, -off), min(n, n - off))
        B[idx + off, idx] = w[j]
    return torch.from_numpy(B).to(device)


def _blur(img: torch.Tensor, window_size: int = 11,
          sigma: float = 1.5) -> torch.Tensor:
    """Depthwise separable Gaussian blur of (C, H, W), SAME zero padding."""
    _, h, w = img.shape
    dev = str(img.device)
    Bw = _band_matrix(w, dev, window_size, sigma)
    Bh = _band_matrix(h, dev, window_size, sigma)
    y = torch.matmul(img, Bw)                      # blur along W
    return torch.matmul(Bh.T, y)                   # blur along H


def ssim_terms(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
               sigma: float = 1.5) -> tuple[torch.Tensor, torch.Tensor]:
    """SSIM's numerator and denominator maps of two (C, H, W) images
    (``ssim_map = num / den``); the denominator is what truncation drives
    through zero (``cli/ssim_probe.py`` reads both)."""
    if img1.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("ssim needs full-f32 matmuls: TF32 truncation "
                           "breaks its variance cancellation")
    stacked = torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    b = _blur(stacked, window_size, sigma)
    c = img1.shape[0]
    mu1, mu2 = b[0:c], b[c:2 * c]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b[2 * c:3 * c] - mu1_sq
    sigma2_sq = b[3 * c:4 * c] - mu2_sq
    sigma12 = b[4 * c:5 * c] - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2.0 * mu12 + c1) * (2.0 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return num, den


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images in [0, 1]."""
    num, den = ssim_terms(img1, img2, window_size, sigma)
    return torch.mean(num / den)
