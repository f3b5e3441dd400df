"""The frozen work counts: the reference's pair counts against brute-force
enumeration of every (pixel, Gaussian) pair on a tiny scene."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import render as R
from perfbench.work import counts


def _scene(seed, n=300, h=40, w=56):
    g = torch.Generator().manual_seed(seed)
    means = torch.stack([torch.empty(n).uniform_(-0.7, 0.7, generator=g),
                         torch.empty(n).uniform_(-0.5, 0.5, generator=g),
                         torch.empty(n).uniform_(1.0, 2.5, generator=g)], 1)
    params = {"means": means, "quats": torch.randn(n, 4, generator=g),
              "log_scales": torch.log(torch.empty(n, 3).uniform_(
                  0.04, 0.12, generator=g)),
              "logit_opacity": torch.empty(n).uniform_(-1.0, 6.0,
                                                       generator=g),
              "sh_dc": torch.randn(n, 1, 3, generator=g),
              "sh_rest": torch.randn(n, 15, 3, generator=g) * 0.1}
    cam = R.Cam(h, w, w * 1.1, w * 1.1, w / 2, h / 2)
    return params, torch.ones(n, dtype=torch.bool), cam


def _brute(p, cam):
    """Every pixel against every Gaussian whose 16 px rect covers it, in
    depth order: (blended pairs, stopping pixels, Gaussians blended)."""
    vis = p["visible"]
    idx = torch.nonzero(vis).squeeze(1)
    idx = idx[torch.argsort(p["depth"][idx], stable=True)]
    blended = stopped = 0
    used = set()
    for y in range(cam.height):
        for x in range(cam.width):
            T = 1.0
            for g in idx.tolist():
                r = p["rect"][g]
                if not (r[0] <= x // 16 < r[2] and r[1] <= y // 16 < r[3]):
                    continue
                mx, my = p["mean2d"][g].tolist()
                a, b, c = p["conic"][g].tolist()
                dx, dy = mx - x, my - y
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                if power > 0:
                    continue
                alpha = min(0.99, float(p["opacity"][g]) * math.exp(power))
                if alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    stopped += 1
                    break
                T *= 1 - alpha
                blended += 1
                used.add(g)
    return blended, stopped, len(used)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_count_matches_brute_force(seed):
    params, active, cam = _scene(seed)
    w2c = torch.eye(4)
    with torch.no_grad():
        p, lay, out, _ = R.render(params, active, w2c, cam, 3)
    b, s, g = _brute(p, cam)
    n_cov = int(torch.unique(lay.gauss).numel()) if lay.gauss.numel() else 0
    # the brute force runs T as a product, the reference in log space: a
    # pixel may stop one pair apart where T sits at 1e-4
    assert abs(out["blended"] - b) <= max(2, 1e-3 * b)
    assert abs(out["stopped"] - s) <= 2
    assert b > 1000 and s > 0
    assert n_cov >= g


def test_counts_are_linear_in_the_geometry():
    ops1, by1 = counts.k1(1000, 10, 50, 16, 16)
    ops2, by2 = counts.k1(2000, 20, 100, 16, 16)
    assert ops2 == 2 * ops1
    assert by2 - by1 == counts.F32 * 10 * 50
    assert counts.k2(1, 0, 0, 0, 0)[0] == counts.BWD_BLEND
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert peak["f32_flops"] == 67e12 and peak["bytes_per_s"] == 3.35e12
    assert counts.peaks("no such card") is None
    assert counts.bound_s(67e12, 0, peak) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12, peak) == pytest.approx(1.0)
    step = counts.mapping_step(1000, 10, 50, 60, 16, 16, 1)
    assert step > counts.k1(1000, 10, 50, 16, 16)[0] + \
        counts.k2(1000, 10, 50, 16, 16)[0]


def test_window_bound_sums_renders():
    work = {"renders": {3: 2, 5: 1}, "height": 16, "width": 16,
            "per_frame": {3: {"blended": 10 ** 6, "stopped": 0,
                              "gaussians": 10},
                          5: {"blended": 3 * 10 ** 6, "stopped": 0,
                              "gaussians": 10}}}
    peak = {"f32_flops": 1e12, "bytes_per_s": 1e15}
    got = counts.window_bound_s(work, counts.k1, peak)
    assert got == pytest.approx(np.float64(5 * 10 ** 6 * counts.FWD_BLEND)
                                / 1e12)
