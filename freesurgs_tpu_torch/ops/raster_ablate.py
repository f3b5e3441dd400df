"""Ablation family of the compositing forward: which of its mechanisms costs
its time (port of ``scripts/kernel_overhead.py``).

    python -m freesurgs_tpu_torch.ops.raster_ablate [--iters N]

builds bench.py's scene (100k Gaussians, SH3, 1280x1024, seed 0) on the
card, bins it as ``render`` does, and prints the CUDA-event time of every
variant and its difference from ``baseline``. Each variant is today's
forward kernel (``csrc/composite_fwd.cu``, K1) with one Hopper mechanism
switched off by a template switch (``csrc/composite_fwd_ablate.cu``):

  baseline  nothing: K1 itself, bit for bit (output and keff)
  nostop    the T < 1e-4 stop, the -inf logT of a stopped pixel, the block
            vote and the skip of a fully stopped warp: every slot of the
            run composites
  norect    the warp-uniform 16 px rect branch: the rect mask passes all
  nobulk    the double-buffered bulk copies: one cooperative synchronous
            load per chunk into one buffer (``baseline``'s function, bit
            for bit)
  rowmap    the quadrant pixel map: the first design's thread -> pixel
            rows, so the rect test diverges inside warps (``baseline``'s
            function, bit for bit)
  linear_t  log-space transmittance: T *= 1 - alpha
  minimal   all of the above

Each variant computes a function of its own, which its plain version (the
switches of ``composite_fwd_plain``) gives on a CPU tensor; on a CUDA
tensor the wrapper launches the kernel and counts the launch in
``LAUNCHES``. There is no fallback between the two.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..bench import bench_scene
from ..core.camera import Camera
from ..core.sh import sh_to_rgb_clamped
from .projection import project_gaussians
from .raster_cuda import (composite_fwd_plain, composite_pair_counts,
                          instance_records, kernel_fn, launch_fwd)
from .render import raster_config


class Mechanisms(NamedTuple):
    stop: bool = True          # T < 1e-4 stop, -inf logT, vote, warp skip
    rect_mask: bool = True     # the 16 px rect branch
    bulk: bool = True          # double-buffered bulk copies (TMA)
    quad: bool = True          # the quadrant pixel map
    linear_t: bool = False     # T as a running product (not log space)

    def plain(self) -> dict:
        """The switches of the plain version (staging and the pixel map
        have no function)."""
        return {"stop": self.stop, "rect_mask": self.rect_mask,
                "linear_t": self.linear_t}


VARIANTS = {
    "baseline": Mechanisms(),
    "nostop": Mechanisms(stop=False),
    "norect": Mechanisms(rect_mask=False),
    "nobulk": Mechanisms(bulk=False),
    "rowmap": Mechanisms(quad=False),
    "linear_t": Mechanisms(linear_t=True),
    "minimal": Mechanisms(stop=False, rect_mask=False, bulk=False,
                          quad=False, linear_t=True),
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

def records_for(cam: Camera, params, grad_sum: str = "direct"):
    """Project the scene and bin it exactly as ``render`` does with this
    ``grad_sum``: (RasterConfig, feat, rect, TileBins, number of
    Gaussians)."""
    means, quats, log_scales, logit_op, sh = params
    with torch.no_grad():
        proj = project_gaussians(means, torch.exp(log_scales), quats, cam)
        opac = torch.sigmoid(logit_op)
        dirs = means * torch.rsqrt(torch.clamp_min(
            (means * means).sum(-1, keepdim=True), 1e-16))
        rgb = sh_to_rgb_clamped(3, sh, dirs)
        rgbz = torch.cat([rgb, proj.depth[:, None]], dim=1)
        cfg = raster_config(cam, grad_sum=grad_sum)
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


def cuda_graph_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` with the host's launch time taken
    out: ``iters`` calls captured in one CUDA graph, whose replay is timed
    by CUDA events. For kernels shorter than the host's time to launch
    them, where ``cuda_ms`` times the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
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
