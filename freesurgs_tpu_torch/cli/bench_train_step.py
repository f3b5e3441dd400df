"""Production train-step throughput: the full mapping step (counterpart of
``scripts/bench_train_step.py``).

    python -m freesurgs_tpu_torch.cli.bench_train_step [--n 100000] \
        [--hw 1024 1280] [--iters 20] [--sh-degree 3] [--two-views] \
        [--maxi 0] [--device cuda|cpu]

Times ``train/steps.py mapping_chunk`` as the training loop runs it:
render (one view, or two with ``--two-views``) -> rgb + Pearson +
local-Pearson losses -> autograd to every Gaussian parameter -> per-group
Adam -> densification statistics, over ``--iters`` iterations of frame 0,
on the JAX script's field (seed 0, the bench scene's recipe with SH rest
terms) with densify off. Every render goes through the compositing kernels
(K1, K2 and the per-Gaussian sum). The rate is a host clock around one
chunk that ends in a synchronize, best of 3 after a warm-up chunk.

Prints one JSON line: ``mapping_step_mpix_per_s`` (``metric``, ``value``,
``unit``), ``ms_per_step``, ``two_views`` and ``device`` (the card's name
and power limit). Differences from the JAX script: ``--maxi`` is the
instance-buffer cap, where 0 (the default) sizes each render's buffer
exactly (up to ``max_instances_cap``); ``--device`` is new. Runs on the
card unless ``--device cpu``; without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.camera import Camera
from ..models.gaussians import GaussianField
from ..train.optim import adam_init
from ..train.steps import MappingState, TrainConfig, mapping_chunk
from ..utils.profiling import device_label, resolve_device, synchronize

N_FRAMES = 2


def build(n: int, hw, sh_degree: int, device, **cfg_kw):
    """The JAX script's set-up: (cam, state, colors (2, 3, H, W), monodeps
    (2, H, W), w2c_all (2, 4, 4), cfg) with densify off."""
    H, W = hw
    sh_k = (sh_degree + 1) ** 2
    rng = np.random.default_rng(0)
    cam = Camera(height=H, width=W, fx=W * 0.78, fy=W * 0.78, cx=W / 2,
                 cy=H / 2)
    arrays = dict(
        means=np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.0, 1.0, n),
                        rng.uniform(0.8, 4.0, n)], -1),
        quats=rng.normal(size=(n, 4)),
        log_scales=np.log(rng.uniform(0.004, 0.012, (n, 3))),
        logit_opacity=rng.uniform(-2, 2, n),
        sh_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
        sh_rest=rng.normal(size=(n, sh_k - 1, 3)).astype(np.float32) * 0.1)
    t = {k: torch.as_tensor(v.astype(np.float32), device=device)
         for k, v in arrays.items()}
    z = torch.zeros(n, device=device)
    field = GaussianField(**t, active=torch.ones(n, dtype=torch.bool,
                                                 device=device),
                          max_radii2d=z, grad_accum=z.clone(),
                          grad_denom=z.clone(),
                          scene_radius=torch.tensor(2.0, device=device),
                          max_sh_degree=sh_degree)
    colors = torch.as_tensor(rng.uniform(size=(N_FRAMES, 3, H, W)).astype(
        np.float32), device=device)
    monodeps = torch.as_tensor(rng.uniform(0.5, 1.5, (N_FRAMES, H, W)).astype(
        np.float32), device=device)
    w2c_all = torch.eye(4, device=device).expand(N_FRAMES, 4, 4)
    cfg = TrainConfig(densify_interval=10**9, **cfg_kw)   # steady state
    gen = torch.Generator()
    gen.manual_seed(0)
    state = MappingState(field, adam_init(field.param_dict()), 0, gen,
                         torch.zeros(N_FRAMES, H, W, device=device),
                         torch.zeros(N_FRAMES, 3, H, W, device=device))
    return cam, state, colors, monodeps, w2c_all, cfg


def run_chunk(state, colors, monodeps, w2c_all, cam, cfg, iters: int,
              two_views: bool, sh_degree: int):
    """``iters`` mapping iterations of frame 0, keyframe 0 (the JAX
    script's ``ts`` and ``kf`` of zeros); densify off."""
    return mapping_chunk(state, colors, monodeps, w2c_all, [0] * iters, [0],
                         cam, cfg, two_views, sh_degree,
                         densify_enabled=False)


def run(args) -> tuple[dict, dict]:
    """The bench: (the JSON line, diagnostics: renders made, the last
    chunk's loss)."""
    dev = resolve_device(args.device)
    cam, st, colors, monodeps, w2c_all, cfg = build(
        args.n, args.hw, args.sh_degree, dev, max_instances=args.maxi)
    label = device_label(dev)

    def chunk():
        return run_chunk(st, colors, monodeps, w2c_all, cam, cfg, args.iters,
                         args.two_views, args.sh_degree)

    chunk()                                  # warm-up: the kernels' build
    synchronize(dev)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        st2, aux = chunk()
        synchronize(dev)
        best = min(best, (time.perf_counter() - t0) / args.iters)
        overflow = float(aux["overflow_max"])
        nonfinite = float(aux["nonfinite_grads"])
        if overflow != 0 or nonfinite != 0:
            raise AssertionError(f"overflow {overflow}, {nonfinite} "
                                 "non-finite gradients")
        if not all(bool(torch.isfinite(v).all())
                   for v in st2.field.param_dict().values()):
            raise AssertionError("a non-finite parameter")
    views = 2 if args.two_views else 1
    renders = 4 * args.iters * views
    H, W = args.hw
    line = {"metric": "mapping_step_mpix_per_s",
            "value": round(H * W / 1e6 / best, 3), "unit": "Mpix/s",
            "ms_per_step": round(best * 1e3, 2),
            "two_views": args.two_views, "device": label}
    diag = {"renders": {"fwd": renders, "bwd": renders},
            "loss": float(aux["loss"])}
    return line, diag


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--hw", type=int, nargs=2, default=[1024, 1280])
    ap.add_argument("--maxi", type=int, default=0,
                    help="instance-buffer cap; 0 sizes each render exactly")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--two-views", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    line, _ = run(parse(argv))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
