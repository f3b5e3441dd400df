#!/usr/bin/env python3
"""Arm A with the JAX fast binner's per-Gaussian gradient sum.

    python3 tests/prefix_sum_arm.py --results <dir> [cli.fullscale's
        other flags]

Runs ``freesurgs_tpu_torch.cli.fullscale`` (the full-res recipe at
cfg34_r5c's settings, on the card) with one change: each Gaussian's sum
of its instance gradients after K2 is taken as a difference of two f32
prefix sums over all of the render's instances,
``cumsum(dsum)[start[g + 1]] - cumsum(dsum)[start[g]]``, which is how the
JAX package's fast binner reduces them (``freesurgs_tpu/ops/
raster_pallas.py`` ``_composite_bwd``, ``fast_binning=True``, the path the
TPU ran) instead of the port's front-to-back sum of each Gaussian's own
rows (``csrc/gaussian_grad_sum.cu``). The prefix runs over the rows in the
port's sum order (Gaussians by slot index; JAX's runs them by depth), in
f32 on the card (``torch.cumsum`` accumulates CUDA f32 in f32). Compositing
still runs through K1 and K2; the sum kernel is not launched.

A diagnostic arm, not a path of the port (and not collected by pytest):
it trains with a slot-order f32 scan in place of the port's sum. That
scan's rounding is not the TPU run's: JAX's prefix runs over the rows in
depth order, and the error of a prefix-sum difference depends on the
running magnitude at each run's position. So the arm can show what such
a reduction costs at full scale, not rule out the TPU run's. Writes what
``cli.fullscale`` writes, plus
``"grad_sum": "prefix_sum_difference"`` in each summary.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def prefix_sum_difference(dsum, start, init=None):
    """(n, 10) per-Gaussian sums of the sum-ordered rows dsum (M, 10) as
    differences of their f32 prefix sums."""
    import torch
    csum = torch.cat([dsum.new_zeros(1, dsum.shape[1]),
                      torch.cumsum(dsum, dim=0)])
    st = start.to(torch.int64)
    out = csum[st[1:]] - csum[st[:-1]]
    return out if init is None else init + out


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO))
    from freesurgs_tpu_torch.cli import fullscale
    from freesurgs_tpu_torch.ops import raster_cuda

    args = fullscale.parse(argv)
    real = raster_cuda.gaussian_grad_sum
    raster_cuda.gaussian_grad_sum = prefix_sum_difference
    try:
        code = fullscale.main(argv)
    finally:
        raster_cuda.gaussian_grad_sum = real
    for name in ("summary.json", "summary_ba.json"):
        path = Path(args.results) / name
        if path.exists():
            s = json.loads(path.read_text())
            s["grad_sum"] = "prefix_sum_difference"
            path.write_text(json.dumps(s, indent=1) + "\n")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
