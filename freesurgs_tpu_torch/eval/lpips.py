"""AlexNet-LPIPS v0.1 in PyTorch (port of ``freesurgs_tpu/eval/lpips_jax.py``).

The ``lpips`` package's AlexNet v0.1 head, written out:

  input (N, 3, H, W) in [-1, 1]
  -> per-channel shift / scale (the package's ScalingLayer)
  -> torchvision AlexNet ``features``, tapping the 5 ReLU outputs:
       conv1 11x11/4 p2 -> relu (tap 1) maxpool 3x3/2
       conv2  5x5/1 p2  -> relu (tap 2) maxpool 3x3/2
       conv3  3x3/1 p1  -> relu (tap 3)
       conv4  3x3/1 p1  -> relu (tap 4)
       conv5  3x3/1 p1  -> relu (tap 5)
  -> per tap: unit-normalize both images' features over channels, squared
     difference, 1x1 non-negative linear head, spatial mean; sum of taps.

Weights: ``load_weights`` reads the .npz that
``scripts/export_lpips_weights.py`` exports (the same file and environment
variable as the JAX module). Without one, ``random_weights`` draws the JAX
module's fixed-seed He-initialized trunk, in the same order from the same
numpy generator, so both packages build the same network. Its values are a
usable perceptual distance but not comparable with published LPIPS.

The convolutions run in f32 with cuDNN's TF32 switched off for the call:
TF32 would keep about three decimal digits of each product.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# (out_ch, in_ch, kh, kw, stride, pad), torchvision AlexNet .features
CONVS = (
    (64, 3, 11, 11, 4, 2),
    (192, 64, 5, 5, 1, 2),
    (384, 192, 3, 3, 1, 1),
    (256, 384, 3, 3, 1, 1),
    (256, 256, 3, 3, 1, 1),
)
# maxpool 3x3 stride 2 after taps 1 and 2
POOL_AFTER = (True, True, False, False, False)

# lpips.ScalingLayer constants (lpips/lpips.py v0.1)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

WEIGHTS_ENV = "FREESURGS_LPIPS_WEIGHTS"
_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "weights",
    "lpips_alex_v01.npz")


def load_weights(path: str | None = None) -> dict | None:
    """{convK_w, convK_b, linK} numpy arrays from an exported .npz, or None
    when there is no such file."""
    path = path or os.environ.get(WEIGHTS_ENV, _DEFAULT_PATH)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        w = {k: np.asarray(z[k], np.float32) for k in z.files}
    for i, (co, ci, kh, kw, _, _) in enumerate(CONVS):
        if (w[f"conv{i}_w"].shape != (co, ci, kh, kw)
                or w[f"lin{i}"].shape != (co,)):
            raise ValueError(f"{path}: layer {i} has the wrong shape")
    return w


def random_weights(seed: int = 0) -> dict:
    """Fixed-seed He-init trunk + uniform heads (random-feature LPIPS), the
    JAX module's draws."""
    rng = np.random.default_rng(seed)
    w = {}
    for i, (co, ci, kh, kw, _, _) in enumerate(CONVS):
        fan_in = ci * kh * kw
        w[f"conv{i}_w"] = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                                     (co, ci, kh, kw)).astype(np.float32)
        w[f"conv{i}_b"] = np.zeros((co,), np.float32)
        w[f"lin{i}"] = np.full((co,), 1.0 / co, np.float32)
    return w


def _features(x: torch.Tensor, w: dict) -> list[torch.Tensor]:
    """The 5 tapped ReLU outputs for input (N, 3, H, W) in [-1, 1]."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    taps = []
    for i, (_, _, _, _, stride, pad) in enumerate(CONVS):
        x = F.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"],
                            stride=stride, padding=pad))
        taps.append(x)
        if POOL_AFTER[i]:
            x = F.max_pool2d(x, 3, 2)
    return taps


def _unit(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


def lpips_pairs(a: torch.Tensor, b: torch.Tensor, weights: dict
                ) -> torch.Tensor:
    """Per-pair LPIPS distance of (N, 3, H, W) stacks in [-1, 1]; weights
    hold tensors on the images' device."""
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled, benchmark=False,
            deterministic=False, allow_tf32=False):
        fa = _features(a, weights)
        fb = _features(b, weights)
        total = torch.zeros(a.shape[0], device=a.device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_unit(xa) - _unit(xb)) ** 2               # (N, C, h, w)
            lin = weights[f"lin{i}"][None, :, None, None]  # 1x1, no bias
            total = total + torch.mean(torch.sum(d * lin, dim=1),
                                       dim=(1, 2))
    return total


def lpips_alex(gts: np.ndarray, preds: np.ndarray,
               weights: dict | None = None, batch: int = 8,
               device="cuda") -> float:
    """Mean AlexNet-LPIPS over (T, 3, H, W) numpy stacks in [0, 1],
    computed on ``device``."""
    if weights is None:
        weights = load_weights() or random_weights()
    dev = torch.device(device)
    w = {k: torch.as_tensor(v, device=dev) for k, v in weights.items()}
    vals = []
    for s in range(0, gts.shape[0], batch):
        a = torch.as_tensor(2.0 * np.asarray(gts[s:s + batch], np.float32)
                            - 1.0, device=dev)
        b = torch.as_tensor(2.0 * np.asarray(preds[s:s + batch], np.float32)
                            - 1.0, device=dev)
        vals.append(lpips_pairs(a, b, w).cpu().numpy())
    return float(np.concatenate(vals).mean())
