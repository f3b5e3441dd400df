"""SSIM precision probe (counterpart of ``scripts/ssim_probe.py``).

    python -m freesurgs_tpu_torch.cli.ssim_probe [--device cuda|cpu] \
        [--height 1024] [--width 1280]

SSIM's variance terms ``E[x^2] - mu^2`` cancel to the scale of C2 = 9e-4
on low-texture windows, so any truncation in the blur's operands (bf16 on
the TPU, TF32 on the card) can drive the SSIM denominator through zero:
SSIM above 1, a negative rgb loss, divergence. The probe evaluates
``ops/ssim.py`` on the worst case, the JAX script's smooth, low-texture
full-resolution pair, against a float64 numpy reference, and makes its
four checks:

  1. ssim(x, x) = 1 to 1e-4;
  2. the mean SSIM of the pair within 1e-4 of the float64 reference;
  3. the smallest SSIM denominator on the device > 0;
  4. max |ssim_map| on the device <= 1 + 1e-3.

Prints one JSON line (the four numbers, the references, ``device``: the
card's name and power limit, ``result`` PASS or FAIL) and exits non-zero
on FAIL. Run it after any change to ``ops/ssim.py``, on the card. It runs
there unless ``--device cpu`` is given; without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.ssim import ssim, ssim_terms
from ..utils.profiling import device_label, resolve_device

C1, C2 = 0.01 ** 2, 0.03 ** 2


def probe_images(height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX script's pair, (3, H, W) float32 each: gentle gradients,
    faint structure and 3e-3 of noise, the regime where the variance
    cancellation is most fragile."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    rng = np.random.default_rng(0)
    base = 0.4 + 0.2 * np.sin(xx / 391.0) * np.cos(yy / 277.0)
    a = np.stack([base + 0.01 * np.sin(xx / 53.0 + i) for i in range(3)])
    b = a + rng.normal(0, 3e-3, a.shape)
    return a.astype(np.float32), np.clip(b, 0, 1).astype(np.float32)


def _blur64(img: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Separable correlation of (C, H, W) with ``w`` along H, then W, zero
    padded (scipy's ``correlate1d(mode="constant")``), in float64."""
    half = len(w) // 2
    out = img.astype(np.float64)
    for axis in (1, 2):
        n = out.shape[axis]
        pad = [(0, 0)] * 3
        pad[axis] = (half, half)
        p = np.pad(out, pad)
        cut = [slice(None)] * 3
        acc = np.zeros_like(out)
        for k, wk in enumerate(w):
            cut[axis] = slice(k, k + n)
            acc += wk * p[tuple(cut)]
        out = acc
    return out


def f64_ssim_stats(a: np.ndarray, b: np.ndarray, window: int = 11,
                   sigma: float = 1.5) -> tuple[float, float]:
    """(mean SSIM, smallest denominator) of (C, H, W) images, blurred in
    float64 (the products in the images' dtype, as in the JAX script's
    reference), on numpy alone."""
    x = np.arange(window) - window // 2
    w = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    w = w / w.sum()
    mu1, mu2 = _blur64(a, w), _blur64(b, w)
    s1 = _blur64(a * a, w) - mu1 * mu1
    s2 = _blur64(b * b, w) - mu2 * mu2
    s12 = _blur64(a * b, w) - mu1 * mu2
    den = (mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2)
    num = (2 * mu1 * mu2 + C1) * (2 * s12 + C2)
    return float((num / den).mean()), float(den.min())


def run(args) -> dict:
    """The probe: its JSON line (``result`` PASS or FAIL)."""
    dev = resolve_device(args.device)
    a, b = probe_images(args.height, args.width)
    ta, tb = (torch.from_numpy(x).to(dev) for x in (a, b))
    with torch.no_grad():
        ssim_self = float(ssim(ta, ta))
        ssim_pair = float(ssim(ta, tb))
        num, den = ssim_terms(ta, tb)
        den_min = float(den.min())
        map_max = float(torch.abs(num / den).max())
    ref_pair, ref_den_min = f64_ssim_stats(a, b)
    checks = {"self_is_one": abs(ssim_self - 1.0) < 1e-4,
              "pair_matches_f64": abs(ssim_pair - ref_pair) < 1e-4,
              "den_min_positive": den_min > 0.0,
              "map_max_within_1e-3": map_max <= 1.0 + 1e-3}
    return {"probe": "ssim", "height": args.height, "width": args.width,
            "ssim_self": ssim_self, "ssim_pair": ssim_pair,
            "ssim_pair_f64": ref_pair, "den_min": den_min,
            "den_min_f64": ref_den_min, "map_max": map_max,
            "checks": checks, "device": device_label(dev),
            "result": "PASS" if all(checks.values()) else "FAIL"}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=1280)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    line = run(parse(argv))
    print(json.dumps(line), flush=True)
    return 0 if line["result"] == "PASS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
