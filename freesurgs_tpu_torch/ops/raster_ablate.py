"""Ablation family of the compositing forward: which of its mechanisms costs
its time (port of ``scripts/kernel_overhead.py``).

    python -m freesurgs_tpu_torch.ops.raster_ablate [--iters N]

builds bench.py's scene (100k Gaussians, SH3, 1280x1024, seed 0) on the
card, bins it as ``render`` does, and prints the CUDA-event time of every
variant and its difference from ``baseline``. Each variant is a copy of
the first design of the forward kernel (``csrc/composite_fwd.cu``, K1: a
thread -> pixel map that spans all four 16 px quadrants in every warp,
cooperative chunk loads) with one mechanism switched off (``csrc/composite_fwd_ablate.cu``):

  baseline  nothing: the first design, which computes K1's function
  nostop    the per-pixel T < 1e-4 stop and the block vote: every slot of
            the run composites
  norect    the 16 px rect tests: the rect mask passes all
  noshared  shared-memory staging: records read from global memory
            (``baseline``'s function, bit for bit)
  linear_t  log-space transmittance: T *= 1 - alpha
  minimal   all four

Each variant computes a function of its own, which its plain version (the
switches of ``composite_fwd_plain``) gives on a CPU tensor; on a CUDA
tensor the wrapper launches the kernel and counts the launch in
``LAUNCHES``. There is no fallback between the two.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import Camera
from ..core.sh import sh_to_rgb_clamped
from .projection import project_gaussians
from .raster_cuda import (composite_fwd_plain, composite_pair_counts,
                          instance_records, kernel_fn, launch_fwd)
from .render import raster_config


class Mechanisms(NamedTuple):
    stop: bool = True          # T < 1e-4 stop, stopped-pixel skip, vote
    rect_mask: bool = True     # the 16 px rect tests
    shared: bool = True        # records staged in shared memory
    linear_t: bool = False     # T as a running product (not log space)

    def plain(self) -> dict:
        """The switches of the plain version (staging has no function)."""
        return {"stop": self.stop, "rect_mask": self.rect_mask,
                "linear_t": self.linear_t}


VARIANTS = {
    "baseline": Mechanisms(),
    "nostop": Mechanisms(stop=False),
    "norect": Mechanisms(rect_mask=False),
    "noshared": Mechanisms(shared=False),
    "linear_t": Mechanisms(linear_t=True),
    "minimal": Mechanisms(stop=False, rect_mask=False, shared=False,
                          linear_t=True),
}

# Kernel launches per variant since the last reset, counted where each
# launches.
LAUNCHES = {name: 0 for name in VARIANTS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _variant(name: str) -> Mechanisms:
    if name not in VARIANTS:
        raise ValueError(f"unknown ablation variant {name!r}; "
                         f"one of {sorted(VARIANTS)}")
    return VARIANTS[name]


def composite_fwd_ablate_plain(name: str, feat, rect, starts, counts,
                               grid_x: int, grid_y: int):
    """Plain version of variant ``name``: (out (8, Hp, Wp), keff)."""
    return composite_fwd_plain(feat, rect, starts, counts, grid_x, grid_y,
                               **_variant(name).plain())


def composite_fwd_ablate(name: str, feat, rect, starts, counts, grid_x: int,
                         grid_y: int):
    """Variant ``name`` of the forward: (out (8, Hp, Wp), keff (T,) int32),
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    _variant(name)
    if not feat.is_cuda:
        return composite_fwd_ablate_plain(name, feat, rect, starts, counts,
                                          grid_x, grid_y)
    res = launch_fwd(kernel_fn("composite_fwd_ablate",
                               f"composite_fwd_ablate_{name}", 6),
                     feat, rect, starts, counts, grid_x, grid_y)
    LAUNCHES[name] += 1
    return res


def ablate_pair_counts(name: str, feat, rect, starts, counts,
                       grid_x: int) -> dict[str, int]:
    """``composite_pair_counts`` of the function variant ``name``
    computes."""
    return composite_pair_counts(feat, rect, starts, counts, grid_x,
                                 **_variant(name).plain())


# ------------------------------------------------------------ the bench scene

def bench_scene(device):
    """bench.py's full-resolution scene recipe, seed 0: (cam, [means, quats,
    log_scales, logit_opacity, sh (N, 16, 3)])."""
    H, W, N = 1024, 1280, 100_000
    rng = np.random.default_rng(0)
    cam = Camera(height=H, width=W, fx=W * 0.78, fy=W * 0.78, cx=W / 2,
                 cy=H / 2)
    means = np.stack([rng.uniform(-1.2, 1.2, N), rng.uniform(-1.0, 1.0, N),
                      rng.uniform(0.8, 4.0, N)], -1).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    log_scales = np.log(rng.uniform(0.004, 0.012, (N, 3))).astype(np.float32)
    logit_op = rng.uniform(-2, 2, N).astype(np.float32)
    sh = (rng.normal(size=(N, 16, 3)).astype(np.float32) * 0.3)
    return cam, [torch.as_tensor(x, device=device) for x in
                 (means, quats, log_scales, logit_op, sh)]


def records_for(cam: Camera, params):
    """Project the scene and bin it exactly as ``render`` does:
    (RasterConfig, feat, rect, TileBins, number of Gaussians)."""
    means, quats, log_scales, logit_op, sh = params
    with torch.no_grad():
        proj = project_gaussians(means, torch.exp(log_scales), quats, cam)
        opac = torch.sigmoid(logit_op)
        dirs = means * torch.rsqrt(torch.clamp_min(
            (means * means).sum(-1, keepdim=True), 1e-16))
        rgb = sh_to_rgb_clamped(3, sh, dirs)
        rgbz = torch.cat([rgb, proj.depth[:, None]], dim=1)
        cfg = raster_config(cam)
        feat, rect, bins = instance_records(proj, rgbz, opac, cfg)
    return cfg, feat, rect, bins, means.shape[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def run_ablation(feat, rect, starts, counts, grid_x: int, grid_y: int,
                 iters: int = 20) -> dict[str, float]:
    """ms per launch of every variant on these records (CUDA events)."""
    return {name: cuda_ms(lambda n=name: composite_fwd_ablate(
                n, feat, rect, starts, counts, grid_x, grid_y), iters)
            for name in VARIANTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20,
                    help="timed launches per variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_ablate: the kernels run only on a CUDA "
                         "device")
    dev = torch.device("cuda", 0)
    t0 = time.time()
    cfg, feat, rect, bins, _ = records_for(*bench_scene(dev))
    ms = run_ablation(feat, rect, bins.tile_start, bins.tile_count,
                      cfg.grid_x, cfg.grid_y, args.iters)
    print(f"{torch.cuda.get_device_name(0)}: bench scene, "
          f"{feat.shape[1]} instances, {args.iters} launches per variant "
          f"({time.time() - t0:.1f} s with the build)")
    base = ms["baseline"]
    for name, t in ms.items():
        diff = "" if name == "baseline" else f" ({t - base:+.4f})"
        print(f"{name:10s} fwd {t:.4f} ms{diff}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
