#!/usr/bin/env python3
"""Where a training iteration's time goes in the PyTorch / CUDA port.

    python3 scripts/torch_profile_slice.py [--iters 10] [--trace PATH]

Builds chip_smoke.py's slice (the full-res synthetic scene, 131,072
initial Gaussians), warms up, then profiles a steady window of mapping
iterations (one view and two views) and of tracking iterations with
torch.profiler. Prints one JSON line per window: wall ms per iteration,
device kernel ms per iteration grouped by kind, the device busy share
(kernel time / wall time) and the top kernels. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# kernel-name substrings -> group, first match wins
GROUPS = (("composite_fwd", "K1 composite_fwd"),
          ("composite_bwd", "K2 composite_bwd"),
          ("sort", "sort (binning)"), ("Sort", "sort (binning)"),
          ("scan", "scan/cumsum"), ("Scan", "scan/cumsum"),
          ("gemm", "matmul (SSIM blur)"), ("sm90_xmma", "matmul (SSIM blur)"),
          ("cutlass", "matmul (SSIM blur)"),
          ("index", "gather/scatter/index"), ("Index", "gather/scatter/index"),
          ("scatter", "gather/scatter/index"),
          ("gather", "gather/scatter/index"),
          ("reduce", "reductions"), ("Reduce", "reductions"),
          ("elementwise", "elementwise"), ("vectorized", "elementwise"),
          ("Memcpy", "memcpy/memset"), ("Memset", "memcpy/memset"))


def group_of(name: str) -> str:
    for key, g in GROUPS:
        if key in name:
            return g
    return "other"


def profile_window(fn, iters: int, trace: str | None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    if trace:
        prof.export_chrome_trace(trace)
    groups: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's event repeats its kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us <= 0:
            continue
        groups[group_of(ev.key)] = groups.get(group_of(ev.key), 0.0) + dev_us
        kernels.append((dev_us, ev.key, ev.count))
    kernels.sort(reverse=True)
    dev_ms = sum(groups.values()) / 1e3
    return {
        "wall_ms_per_iter": wall * 1e3 / iters,
        "device_ms_per_iter": dev_ms / iters,
        "device_busy_share": dev_ms / (wall * 1e3),
        "groups_ms_per_iter": {k: v / 1e3 / iters for k, v in
                               sorted(groups.items(), key=lambda x: -x[1])},
        "top_kernels": [{"name": k[:90], "ms_per_iter": us / 1e3 / iters,
                         "calls": c} for us, k, c in kernels[:12]],
    }


def main() -> int:
    import subprocess

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the two-view window here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_slice: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from freesurgs_tpu_torch.data.synthetic import SceneSequence, make_scene
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    scene = make_scene(num_frames=4, n_gaussians=20000, height=1024,
                       width=1280, seed=7, scale_range=(0.004, 0.012),
                       device=dev)
    cfg = TrainConfig(tracking_gn_iters=0, tracking_iters=args.iters,
                      densify_interval=10_000, opacity_reset_interval=10_000)
    tr = Trainer(SceneSequence(scene), cfg, sh_degree_max=3, device=dev,
                 log_fn=lambda *a: None)
    tr.active_sh_degree = 3
    tr._map_frame(0, 3, two_views=False)         # warm-up (build, caches)
    tr.keyframes.append(0)
    n = args.iters
    out = {"device": smi}
    out["mapping_one_view"] = profile_window(
        lambda: tr._map_frame(0, n, two_views=False), n, None)
    out["mapping_two_views"] = profile_window(
        lambda: tr._map_frame(1, n, two_views=True), n, args.trace)
    out["tracking"] = profile_window(lambda: tr.track_frame(1), n, None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
