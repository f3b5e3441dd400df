"""Headline benchmark of the port: rendered Mpix/s, forward + backward, at
100k Gaussians (counterpart of the root ``bench.py``).

    python -m freesurgs_tpu_torch.bench [--device cuda|cpu]

Prints one JSON line with ``bench.py``'s keys (``render_fwdbwd_mpix_per_s``
and ``amortized_train_mpix_per_s``, ``vs_baseline`` against the same
literature constant) plus ``device`` (the card's name and power limit),
``iters``, ``ms_per_iter_median`` with its ``median_samples``,
``device_busy_share``, ``step_costs`` and ``rates_after_tracing``.

The scene is ``bench.py``'s: 100k Gaussians, SH degree 3, 1280x1024, seed
0; the loss ``mean(render^2) + 0.1 mean(render_dep)``, with gradients to
all five parameter groups, and each step's means depending on the step
before (``m + 0 * dL/dm``). Every render goes through ``ops/render.py``
and the compositing kernels (K1, K2 and the per-Gaussian sum). With
``--device cpu`` the scene shrinks to ``bench.py``'s CPU shapes (64x64,
2,000 Gaussians, SH degree 0) and runs the kernels' plain versions; that
is the only CPU path, and without a card and without it the bench raises.

Timing. The port runs eagerly, so the rate is a host clock around
``ITERS`` steps that ends in a synchronize, best of 3: what the training
loop sees. ``ms_per_iter_median`` is the median of per-step times taken
in another window, each step ending in a synchronize. ``device_busy_share``
is kernel time over wall time from ``torch.profiler`` over a third window,
untimed, so that tracing stays out of the timed ones. The amortized rate
carries the binning layout (``render(bins=, rebin=)``) and rebins every
``REBIN_EVERY`` steps, as the training loops do with ``rebin_every=4``;
its binnings are counted (``raster_cuda.BINS``) and must be
``ceil(iters / REBIN_EVERY)`` a window. Both rates are timed before any
pass that traces or counts; ``step_costs`` then takes one window of each
kind apart, step by step (``step_costs``): a fresh step, and the
amortized window's binning and carried steps, each with its host syncs,
device ms and wall ms; ``rates_after_tracing`` times both windows again
after those passes (None on the CPU, where nothing is traced). The first
render's overflow must be 0, and every loss and gradient finite.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import numpy as np
import torch

from .core.camera import Camera
from .ops import raster_cuda as rc
from .ops.render import render
from .utils.profiling import (count_syncs, device_label, device_time,
                              resolve_device, synchronize)

# The root bench.py's divisor: a literature estimate of the CUDA
# rasterizer's fwd+bwd rate on an RTX-3090-class GPU (bench.py's docstring).
BASELINE_MPIX_S = 5.0
BASELINE_SOURCE = "literature-estimate RTX3090 ~5 Mpix/s"
REBIN_EVERY = 4
ITERS = 8                  # steps a timed window, a multiple of REBIN_EVERY
FULL_SHAPES = dict(height=1024, width=1280, n=100_000, sh_degree=3)
CPU_SHAPES = dict(height=64, width=64, n=2_000, sh_degree=0)


def bench_scene(device, height: int = 1024, width: int = 1280,
                n: int = 100_000, sh_degree: int = 3):
    """bench.py's scene recipe, seed 0: (cam, [means, quats, log_scales,
    logit_opacity, sh (n, (sh_degree + 1)^2, 3)])."""
    rng = np.random.default_rng(0)
    cam = Camera(height=height, width=width, fx=width * 0.78,
                 fy=width * 0.78, cx=width / 2, cy=height / 2)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(0.8, 4.0, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    log_scales = np.log(rng.uniform(0.004, 0.012, (n, 3))).astype(np.float32)
    logit_op = rng.uniform(-2, 2, n).astype(np.float32)
    sh = (rng.normal(size=(n, (sh_degree + 1) ** 2, 3)).astype(np.float32)
          * 0.3)
    return cam, [torch.as_tensor(x, device=device) for x in
                 (means, quats, log_scales, logit_op, sh)]


def bench_loss(out: dict) -> torch.Tensor:
    return torch.mean(out["render"] ** 2) + 0.1 * torch.mean(
        out["render_dep"])


class Bench:
    """The bench scene on one device, and the renders made on it
    (``fwd`` forward, ``bwd`` backward), which the kernels' launch counts
    must equal."""

    def __init__(self, device, shapes: dict):
        self.dev = torch.device(device)
        self.sh_degree = shapes["sh_degree"]
        self.cam, self.params = bench_scene(self.dev, **shapes)
        self.eye = torch.eye(4, device=self.dev)
        self.fwd = self.bwd = 0

    def render(self, params, **kw) -> dict:
        self.fwd += 1
        return render(*params, self.eye, self.cam,
                      sh_degree=self.sh_degree, **kw)

    def grad_step(self, means, bins=None, rebin=None):
        """One loss and its gradients to the five groups, at ``means``:
        (loss, grads, the layout used or None)."""
        params = [p.detach().requires_grad_(True)
                  for p in [means, *self.params[1:]]]
        out = self.render(params, bins=bins, rebin=rebin)
        loss = bench_loss(out)
        grads = torch.autograd.grad(loss, params)
        self.bwd += 1
        return loss.detach(), grads, out.get("bins")

    def steps(self, iters: int, rebin_every: int | None = None,
              sync_each: bool = False):
        """``iters`` steps, each one's means ``m + 0 * dL/dm`` of the one
        before; with ``rebin_every`` the layout is carried and rebuilt at
        every ``rebin_every``-th step (the first included). Returns the
        last means, every step's loss, the last gradients and, with
        ``sync_each``, each step's seconds."""
        m, bins, losses, times = self.params[0], None, [], []
        for i in range(iters):
            t0 = time.perf_counter()
            rebin = None if rebin_every is None else i % rebin_every == 0
            loss, grads, bins = self.grad_step(m, bins, rebin)
            m = m + 0.0 * grads[0]
            losses.append(loss)
            if sync_each:
                synchronize(self.dev)
                times.append(time.perf_counter() - t0)
        return m, losses, grads, times

    def best_window(self, iters: int, rebin_every: int | None = None,
                    reps: int = 3) -> float:
        """Best of ``reps`` host-clock windows of ``iters`` steps, each
        ending in a synchronize: seconds per step. Each window's losses
        and last gradients must be finite, and with a carried layout its
        binnings ``ceil(iters / rebin_every)``."""
        best = float("inf")
        for _ in range(reps):
            rc.reset_bins()
            synchronize(self.dev)
            t0 = time.perf_counter()
            m, losses, grads, _ = self.steps(iters, rebin_every)
            synchronize(self.dev)
            best = min(best, (time.perf_counter() - t0) / iters)
            check_finite(m, torch.stack(losses), *grads)
            if rebin_every is not None:
                binned = rc.BINS["build_tile_bins"]
                want = math.ceil(iters / rebin_every)
                if binned != want:
                    raise AssertionError(f"{binned} binnings in {iters} "
                                         f"amortized steps, not {want}")
        return best


def step_costs(b: Bench, iters: int, rebin_every: int | None = None
               ) -> dict:
    """One window of ``iters`` steps taken apart: each step alone, its host
    syncs (``count_syncs``), device ms (``device_time``) and wall ms
    (between two synchronizes), in three passes over the window that chain
    the means and the layout as ``Bench.steps`` does. Grouped by the
    step's kind, "fresh" (no carry), "rebin" (a carry's binning) or
    "carried" (the layout reused): the mean syncs and the median device
    and wall ms; syncs and device ms are None on the CPU."""
    dev = b.dev

    def wall_ms(fn):
        synchronize(dev)
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    def device_ms(fn):
        traced = device_time(fn, dev)
        return None if traced is None else traced[0] * 1e3

    def window(measure) -> dict[str, list]:
        m, bins, by_kind = b.params[0], None, {}
        for i in range(iters):
            rebin = None if rebin_every is None else i % rebin_every == 0
            res = []
            value = measure(lambda: res.append(b.grad_step(m, bins, rebin)))
            _, grads, bins = res[0]
            m = m + 0.0 * grads[0]
            kind = ("fresh" if rebin is None else "rebin" if rebin
                    else "carried")
            by_kind.setdefault(kind, []).append(value)
        return by_kind

    walls = window(wall_ms)
    if dev.type != "cuda":
        return {kind: {"steps": len(w), "host_syncs": None,
                       "device_ms": None, "wall_ms": statistics.median(w)}
                for kind, w in walls.items()}
    syncs = window(count_syncs)
    devs = window(device_ms)
    return {kind: {
        "steps": len(w), "host_syncs": statistics.mean(syncs[kind]),
        "device_ms": None if None in devs[kind] else statistics.median(
            devs[kind]),
        "wall_ms": statistics.median(w)} for kind, w in walls.items()}


def check_finite(*tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("a non-finite loss, output or gradient")


def run(device: str = "cuda", iters: int = ITERS) -> tuple[dict, dict]:
    """The bench: (the JSON line, diagnostics: renders made, binnings of
    the last amortized window, the first render's instances)."""
    dev = resolve_device(device)
    b = Bench(dev, CPU_SHAPES if dev.type == "cpu" else FULL_SHAPES)
    label = device_label(dev)

    with torch.no_grad():
        out = b.render(b.params)
    overflow = int(out["overflow"])
    if overflow != 0:
        raise AssertionError(f"instance capacity too small: {overflow} "
                             "dropped")
    check_finite(*(out[k] for k in ("render", "render_dep", "final_T")))
    instances = int(out["num_instances"])

    b.steps(1)                              # warm-up: the kernels' build
    b.steps(iters, REBIN_EVERY)             # warm-up of the carry
    # every timed window before the passes that trace or count syncs;
    # on the card both windows are timed again after them
    dt = b.best_window(iters)
    dta = b.best_window(iters, REBIN_EVERY)
    binnings = rc.BINS["build_tile_bins"]
    _, _, _, times = b.steps(iters, sync_each=True)
    traced = device_time(lambda: b.steps(iters), dev)
    costs = step_costs(b, iters) | step_costs(b, iters, REBIN_EVERY)
    mpix = b.cam.height * b.cam.width / 1e6
    after = None if traced is None else {
        "raw": mpix / b.best_window(iters),
        "amortized": mpix / b.best_window(iters, REBIN_EVERY)}

    line = {
        "metric": "render_fwdbwd_mpix_per_s",
        "value": round(mpix / dt, 3),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix / dt / BASELINE_MPIX_S, 3),
        "baseline_source": BASELINE_SOURCE,
        "amortized_train_mpix_per_s": round(mpix / dta, 3),
        "amortized_rebin_every": REBIN_EVERY,
        "device": label,
        "iters": iters,
        "ms_per_iter_median": statistics.median(times) * 1e3,
        "median_samples": len(times),
        "device_busy_share": None if traced is None else (
            traced[0] / traced[1]),
        "step_costs": costs,
        "rates_after_tracing": after,
    }
    diag = {"renders": {"fwd": b.fwd, "bwd": b.bwd},
            "amortized_binnings": binnings,
            "num_instances": instances, "ms_per_iter": dt * 1e3,
            "amortized_ms_per_iter": dta * 1e3}
    return line, diag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (bench.py's CPU shapes)")
    line, _ = run(ap.parse_args(argv).device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
