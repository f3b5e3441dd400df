"""Stage-level timing of one render at the bench scene (counterpart of
``scripts/stage_timing.py``).

    python -m freesurgs_tpu_torch.cli.stage_timing [--n 100000] \
        [--hw 1024 1280] [--iters 5] [--maxi 0] [--device cuda|cpu]

Five nested stages, each a chain of ``--iters`` calls in which every call's
means depend on the call before (``m + 0 * stage(m)``, the stage reduced to
a scalar), so a stage's cost is its time minus the stage before's:

  1. projection     ``ops/project_cuda.raster_inputs``, as ``render`` runs
                    it: world->camera, EWA, tile rects, opacity and SH
                    colours (one kernel on the card)
  2. (+)binning     the opacity pre-prune and snug rects, ``derive_bin_rect``
                    and the sort binner ``build_tile_bins`` with its sum
                    layout (``sum_layout``): what ``rasterize`` bins with
  3. (+)records     the per-slot records the kernels read
                    (``raster_cuda._records``: field columns, packed rects,
                    ``_build_feat``)
  4. full fwd       ``render``: the above and K1
  5. fwd+bwd        the bench loss's gradient to the means: K2 and the
                    per-Gaussian sum as well

Each chain is timed with CUDA events and with the host clock (ending in a
synchronize), best of 2 after a warm-up chain, and traced once more by
``torch.profiler`` for the kernels' own time per call (``kernel_ms``).
The events bracket the whole chain on the stream, the device's waits for
the host included, so they sit close to the host clock when the host
sets the pace; ``kernel_ms`` against them is the device's busy share per
stage. Prints one line per stage and then one JSON line with every
stage's times, deltas and ``device`` (the card's name and power limit).
The scene is ``bench.py``'s (``freesurgs_tpu_torch.bench``).

Differences from the JAX script: stage 1 is the port's whole projection,
SH colours and opacity included (the JAX script colours in stage 3), since
``render`` runs it as one kernel on the card; the port's bins are 32 px
with the 16 px rect mask, so ``--bin-tile`` takes only 32 (ROADMAP Queue
3); the binner is the sort binner (the JAX script times ``binning_fast``,
which the port leaves out); ``--maxi`` 0 (the default) sizes each layout
exactly.
Events exist only on the card: on the CPU the host clock stands in for
them. Runs on the card unless ``--device cpu``; without a CUDA device it
fails.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..bench import bench_loss, bench_scene
from ..ops import raster_cuda as rc
from ..ops.binning import build_tile_bins, derive_bin_rect
from ..ops.project_cuda import raster_inputs
from ..ops.render import raster_config, render
from ..utils.profiling import (device_label, device_time, resolve_device,
                              synchronize)

STAGES = ("projection", "(+)binning", "(+)records", "full fwd", "fwd+bwd")


def stage_fns(cam, params, sh_degree: int, max_instances: int = 0):
    """The five stages as functions of the means, each returning a scalar
    (the JAX script's ``s_proj`` ... ``s_bwd``), and the render each of
    stages 4-5 makes per call (forward, backward)."""
    _, quats, log_scales, logit_op, sh = params
    cfg = raster_config(cam, max_instances)
    eye = torch.eye(4, device=quats.device)

    def project(m):
        return raster_inputs(m, quats, log_scales, logit_op, sh, eye, cam,
                             None, None, sh_degree)

    def binned_with(m):
        proj, rgbz, opac = project(m)
        p = rc._prune_and_snug(proj, opac)
        bins = build_tile_bins(derive_bin_rect(p, cfg.bin_scale),
                               cfg.grid_x, cfg.grid_y, cfg.max_instances)
        return p, bins, rgbz, opac

    def binned(m):
        return binned_with(m)[:2]

    def records(m):
        p, bins, rgbz, opac = binned_with(m)
        feat, rect = rc._records(p.mean2d, p.conic, rgbz, opac, p.tile_rect,
                                 bins.gather_idx)
        return feat, rect, bins

    def s_proj(m):
        p = project(m)[0]
        return torch.sum(p.mean2d[:, 0]) + torch.sum(p.depth)

    def s_bins(m):
        return torch.sum(binned(m)[1].gather_idx).to(torch.float32)

    def s_records(m):
        return torch.sum(records(m)[0])

    def s_fwd(m):
        out = render(m, quats, log_scales, logit_op, sh, eye, cam,
                     sh_degree=sh_degree, max_instances=max_instances)
        return torch.mean(out["render"])

    def s_bwd(m):
        m = m.detach().requires_grad_(True)
        out = render(m, quats, log_scales, logit_op, sh, eye, cam,
                     sh_degree=sh_degree, max_instances=max_instances)
        return torch.sum(torch.autograd.grad(bench_loss(out), m)[0])

    fns = dict(zip(STAGES, (s_proj, s_bins, s_records, s_fwd, s_bwd)))
    renders = dict(zip(STAGES, ((0, 0), (0, 0), (0, 0), (1, 0), (1, 1))))
    return fns, renders, {"binned": binned, "records": records}


def chain(fn, m, iters: int):
    for _ in range(iters):
        m = m + 0.0 * fn(m)
    return m


def time_chain(fn, m, iters: int, dev):
    """(host-clock ms, CUDA-event ms, kernel ms) per call of ``fn`` in a
    chain of ``iters``: the clocks best of 2 after a warm-up chain, the
    kernel time from ``torch.profiler`` over one more chain, untimed. The
    last two only on the card. The chain's result must be finite."""
    chain(fn, m, iters)
    synchronize(dev)
    host = event = float("inf")
    for _ in range(2):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        out = chain(fn, m, iters)
        if dev.type == "cuda":
            b.record()
        synchronize(dev)
        host = min(host, (time.perf_counter() - t0) * 1e3 / iters)
        if dev.type == "cuda":
            event = min(event, a.elapsed_time(b) / iters)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("a non-finite stage output")
    traced = device_time(lambda: chain(fn, m, iters), dev)
    return (host, event if dev.type == "cuda" else None,
            None if traced is None else traced[0] * 1e3 / iters)


def run(args) -> tuple[dict, dict]:
    """The stages: (the JSON line, diagnostics: renders made, and the
    projections made outside a render: stages 1-3 project once a call)."""
    if args.bin_tile != rc.BIN:
        raise ValueError(
            f"--bin-tile {args.bin_tile}: the port bins at {rc.BIN} px with "
            "the 16 px rect mask; other bin sizes have no counterpart "
            "(ROADMAP Queue 3)")
    dev = resolve_device(args.device)
    H, W = args.hw
    cam, params = bench_scene(dev, height=H, width=W, n=args.n,
                              sh_degree=3)
    label = device_label(dev)
    fns, per_call, _ = stage_fns(cam, params, 3, args.maxi)
    with torch.no_grad():
        out = render(*params, torch.eye(4, device=dev), cam, sh_degree=3,
                     max_instances=args.maxi)
    overflow, instances = int(out["overflow"]), int(out["num_instances"])
    if overflow != 0:
        raise AssertionError(f"instance capacity too small: {overflow} "
                             "dropped")
    renders = {"fwd": 1, "bwd": 0}
    projections = 0
    rows, prev_host, prev_event = [], 0.0, 0.0
    print(f"config: {H}x{W}, N={args.n}, instances={instances}, "
          f"bin_tile={rc.BIN}, {label}", flush=True)
    for name in STAGES:
        host, event, kernel = time_chain(fns[name], params[0], args.iters,
                                         dev)
        f, b = per_call[name]
        chains = 3 if dev.type == "cpu" else 4
        renders["fwd"] += chains * args.iters * f
        renders["bwd"] += chains * args.iters * b
        projections += chains * args.iters * (f == 0)
        ms = event if event is not None else host
        prev = prev_event if event is not None else prev_host
        rows.append({"stage": name, "ms": event, "delta_ms": (
            None if event is None else event - prev_event), "host_ms": host,
            "host_delta_ms": host - prev_host, "kernel_ms": kernel})
        kern = "" if kernel is None else f"  kernels {kernel:8.3f} ms"
        print(f"{name:12s} {ms:8.3f} ms  (delta {ms - prev:+8.3f} ms)  "
              f"host {host:8.3f} ms{kern}", flush=True)
        prev_host, prev_event = host, (event or 0.0)
    line = {"metric": "stage_ms", "height": H, "width": W, "n": args.n,
            "instances": instances, "bin_tile": rc.BIN, "iters": args.iters,
            "stages": rows, "device": label}
    return line, {"renders": renders, "projections": projections}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--hw", type=int, nargs=2, default=[1024, 1280])
    ap.add_argument("--maxi", type=int, default=0,
                    help="instance-buffer cap; 0 sizes each layout exactly")
    ap.add_argument("--bin-tile", type=int, default=rc.BIN,
                    help="only 32: the port's bin size")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    line, _ = run(parse(argv))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
