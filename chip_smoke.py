#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (freesurgs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  1. device  — torch's device name and count, and nvidia-smi's name and
     power limit (also printed raw on a line of its own);
  2. build   — nvcc builds every kernel from csrc/ (ptxas registers, shared
     memory and spills per kernel);
  3. parity  — each compositing kernel against its plain PyTorch version on
     bench.py's scene (100k Gaussians, SH3, 1280x1024, seed 0);
  4. timing  — CUDA-event times of each kernel and its plain version, with
     the least time the card could take (bound_ms);
  5. slice   — the progressive SLAM trainer at 1280x1024 from 131,072
     initial Gaussians, depth cut through TrainConfig so that densify, the
     opacity reset and SH degree 3 all happen; launch counters reset just
     before it and read just after;
  6. kernels — one JSON line with every kernel's numbers;
then, last, {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, when there is no CUDA device or
the package is not beside this script; any failed check raises.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and non-tensor f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations (a transcendental counts as one) per (instance, pixel)
# pair, by the work the pair needs (rc.composite_pair_counts), counted from
# csrc/: "cut" = dy, the power (9), its test, exp, raw = o exp and its test
# (14); "stopping" adds min(0.99, raw), T = exp(logT) and the T (1 - alpha)
# test (19); "blended" adds, in the forward, w, the 6-channel blend and
# logT += log1p(-alpha) (34), and in the backward cg, the running sum,
# dalpha, the chain to the 10 fields and logT (78). Pairs whose rect misses
# the pixel (an integer test) or that come after the pixel's stop count 0,
# as do K2's per-record warp reductions: the bound stays a lower bound.
FWD_OPS = {"cut": 14, "stopping": 19, "blended": 34}
BWD_OPS = {"cut": 14, "stopping": 19, "blended": 78}

# Kernel vs plain tolerances. Both sum the same terms in another order
# (sequential f32 in the kernel, cumsum + einsum in the plain version), so
# outputs agree to f32 reassociation; the stop decisions compare
# T * (1 - alpha) with 1e-4, which reassociation can flip only for a pixel
# whose product lands within an ulp of the cutoff.
FWD_CHANNEL_TOL = 2e-5      # per channel, relative to max(1, |channel|)
FWD_STOP_DIFF_FRAC = 1e-4   # share of pixels whose stop index may differ
BWD_FIELD_TOL = 5e-5        # per-Gaussian gradient, normalized per field
#                             (the JAX package's oracle-vs-Pallas gate)


def phase(name: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3),
                      **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
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


def bench_scene(dev):
    """bench.py's full-resolution scene recipe, seed 0."""
    import numpy as np
    import torch
    from freesurgs_tpu_torch.core.camera import Camera
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
    t = [torch.as_tensor(x, device=dev) for x in
         (means, quats, log_scales, logit_op, sh)]
    return cam, t


def records_for(cam, params):
    """Project the scene and bin it exactly as render() does."""
    import torch
    from freesurgs_tpu_torch.core.sh import sh_to_rgb_clamped
    from freesurgs_tpu_torch.ops.projection import project_gaussians
    from freesurgs_tpu_torch.ops.raster_cuda import instance_records
    from freesurgs_tpu_torch.ops.render import raster_config
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


def parity_and_timing(dev, results):
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc

    t0 = time.time()
    cam, params = bench_scene(dev)
    cfg, feat, rect, bins, n = records_for(cam, params)
    gx, gy = cfg.grid_x, cfg.grid_y
    starts, counts, gidx = bins.tile_start, bins.tile_count, bins.gather_idx
    m = feat.shape[1]
    check(int(bins.overflow) == 0, f"bench scene overflowed: {bins.overflow}")

    out_k, keff_k = rc.composite_fwd(feat, rect, starts, counts, gx, gy)
    torch.cuda.synchronize()
    out_p, keff_p = rc.composite_fwd_plain(feat, rect, starts, counts, gx, gy)
    torch.cuda.synchronize()
    H, W = cam.height, cam.width
    fails = []
    ch_err = []
    for c in range(7):
        a, b = out_k[c, :H, :W], out_p[c, :H, :W]
        ch_err.append(float((a - b).abs().max()))
        scale = max(1.0, float(b.abs().max()))
        if not ch_err[-1] <= FWD_CHANNEL_TOL * scale:
            fails.append(f"K1 channel {c}: max abs err {ch_err[-1]} > "
                         f"{FWD_CHANNEL_TOL} x {scale}")
    stop_diff = int((out_k[7] != out_p[7]).sum())
    keff_diff = int((keff_k != keff_p).sum())
    if not stop_diff <= FWD_STOP_DIFF_FRAC * out_k[7].numel():
        fails.append(f"K1: {stop_diff} pixels stop at another instance")
    fwd_err = max(ch_err)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gout = torch.randn(out_k.shape, generator=gen, device=dev)
    gout[7] = 0.0
    gout[:, H:, :] = 0.0
    gout[:, :, W:] = 0.0
    dfeat_k = rc.composite_bwd(feat, rect, starts, counts, keff_k, out_k,
                               gout, gx, gy)
    torch.cuda.synchronize()
    dfeat_p = rc.composite_bwd_plain(feat, rect, starts, counts, gout, gx, gy)
    torch.cuda.synchronize()
    inst_err = float((dfeat_k - dfeat_p).abs().max())
    inst_scale = float(dfeat_p.abs().max())

    def per_gaussian(d):
        return torch.zeros(n + 1, rc.N_FIELD, device=dev).index_add_(
            0, gidx, d.T)[:n]

    gk, gp = per_gaussian(dfeat_k), per_gaussian(dfeat_p)
    field_err = []
    for f in range(rc.N_FIELD):
        scale = max(float(gp[:, f].abs().max()), 1e-12)
        field_err.append(float((gk[:, f] - gp[:, f]).abs().max()) / scale)
    if not max(field_err) <= BWD_FIELD_TOL:
        fails.append(f"K2: normalized per-Gaussian gradient err {field_err}")
    phase("parity", t0, instances=m, tiles=gx * gy,
          fwd_max_abs_err_per_channel=ch_err, fwd_stop_index_diff=stop_diff,
          keff_diff=keff_diff, bwd_max_abs_err_per_instance=inst_err,
          bwd_max_abs_per_instance=inst_scale,
          bwd_normalized_err_per_field=field_err,
          tolerances={"fwd_channel": FWD_CHANNEL_TOL,
                      "fwd_stop_frac": FWD_STOP_DIFF_FRAC,
                      "bwd_field": BWD_FIELD_TOL})
    check(not fails, "; ".join(fails))

    t0 = time.time()
    ms_fwd = cuda_ms(lambda: rc.composite_fwd(feat, rect, starts, counts,
                                              gx, gy), iters=20)
    ms_bwd = cuda_ms(lambda: rc.composite_bwd(feat, rect, starts, counts,
                                              keff_k, out_k, gout, gx, gy),
                     iters=20)
    plain_fwd = cuda_ms(lambda: rc.composite_fwd_plain(
        feat, rect, starts, counts, gx, gy), iters=3, warmup=1)
    plain_bwd = cuda_ms(lambda: rc.composite_bwd_plain(
        feat, rect, starts, counts, gout, gx, gy), iters=3, warmup=1)
    # the pairs these records need, by kind, and the slots walked (every
    # pixel of a tile against its instances up to keff) for comparison
    pairs = rc.composite_pair_counts(feat, rect, starts, counts, gx)
    slots = float((torch.minimum(counts, keff_k * rc.CHUNK).to(torch.float64)
                   * rc.NPIX).sum())
    fwd_ops = float(sum(FWD_OPS[k] * v for k, v in pairs.items()))
    bwd_ops = float(sum(BWD_OPS[k] * v for k, v in pairs.items()))
    nt = gx * gy
    img = 8 * gy * rc.BIN * gx * rc.BIN * 4
    fwd_bytes = 4 * (rc.N_FIELD * m + m + 3 * nt) + img
    bwd_bytes = 4 * (2 * rc.N_FIELD * m + m + 3 * nt) + 2 * img * 7 // 8
    kernels = []
    for name, src, rep, ms, pms, ops, nbytes, err in (
            ("composite_fwd", "freesurgs_tpu_torch/csrc/composite_fwd.cu",
             "freesurgs_tpu/ops/raster_pallas.py:307", ms_fwd, plain_fwd,
             fwd_ops, fwd_bytes, fwd_err),
            ("composite_bwd", "freesurgs_tpu_torch/csrc/composite_bwd.cu",
             "freesurgs_tpu/ops/raster_pallas.py:415", ms_bwd, plain_bwd,
             bwd_ops, bwd_bytes, inst_err)):
        t_ops = ops / PEAK_F32_PER_S * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})
    results["kernels"] = kernels
    phase("timing", t0, instances=m, keff_sum=int(keff_k.sum()),
          pairs=pairs, pixel_slots_to_keff=slots, fwd_ops=fwd_ops,
          bwd_ops=bwd_ops, fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes,
          fwd_ms=ms_fwd, bwd_ms=ms_bwd, fwd_plain_ms=plain_fwd,
          bwd_plain_ms=plain_bwd,
          fwd_bound_ms=kernels[0]["bound_ms"],
          bwd_bound_ms=kernels[1]["bound_ms"],
          fwd_share_of_bound=kernels[0]["bound_ms"] / ms_fwd,
          bwd_share_of_bound=kernels[1]["bound_ms"] / ms_bwd,
          library_ms=None,
          library_note="no single PyTorch call computes this function")


def psnr(img, gt) -> float:
    import torch
    mse = float(torch.mean((torch.clamp(img, 0, 1) - gt) ** 2))
    return -10.0 * math.log10(max(mse, 1e-12))


def run_slice(dev, results):
    import torch
    from freesurgs_tpu_torch.core.transforms import quat_to_rotmat
    from freesurgs_tpu_torch.data.synthetic import SceneSequence, make_scene
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    # scripts/make_fullres_dataset.py's recipe, 4 frames. Frame 1 is a test
    # frame: tracked and rendered into the depth cache (which frame 2's
    # flow loss reads), not mapped.
    scene = make_scene(num_frames=4, n_gaussians=20000, height=1024,
                       width=1280, seed=7, scale_range=(0.004, 0.012),
                       device=dev)
    seq = SceneSequence(scene, i_test=[1])
    cfg = TrainConfig(tracking_gn_iters=0, first_frame_mapping_iters=30,
                      mapping_iters=10, tracking_iters=10,
                      densify_interval=40, opacity_reset_interval=50,
                      sh_increase_interval=10)
    logs = []
    tr = Trainer(seq, cfg, sh_degree_max=3, init_mask_frac=0.1, device=dev,
                 log_fn=logs.append)
    torch.cuda.synchronize()
    phase("slice_setup", t0, init_gaussians=int(tr.field.num_active),
          capacity=tr.field.capacity, log=logs[:])
    check(int(tr.field.num_active) == 131_072, "expected 131,072 Gaussians")

    rc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out_before = tr.render_frame(0)
    psnr_before = psnr(out_before["render"], seq.colors[0])
    tr.progressive_run()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(rc.LAUNCHES)

    n_train = [t for t in range(4) if t in set(seq.i_train.tolist())]
    n_test = [t for t in range(4) if t not in n_train]
    exp_fwd, exp_bwd, iters = 1, 0, 0     # the render_frame(0) above
    for t in range(4):
        if t > 0:
            exp_fwd += cfg.tracking_iters
            exp_bwd += cfg.tracking_iters
            iters += cfg.tracking_iters
        if t in n_test:
            exp_fwd += 1
        elif t == 0:
            exp_fwd += cfg.first_frame_mapping_iters
            exp_bwd += cfg.first_frame_mapping_iters
            iters += cfg.first_frame_mapping_iters
        else:
            exp_fwd += 2 * cfg.mapping_iters
            exp_bwd += 2 * cfg.mapping_iters
            iters += cfg.mapping_iters

    frames = []
    for h in tr.history:
        t = h["frame"]
        R_est = quat_to_rotmat(tr.poses.quats[t])
        R_gt = quat_to_rotmat(scene.gt_quats[t])
        cosang = (torch.trace(R_est.T @ R_gt) - 1.0) / 2.0
        rot_deg = math.degrees(math.acos(max(-1.0, min(1.0, float(cosang)))))
        frames.append({
            **{k: (float(v) if torch.is_tensor(v) else v)
               for k, v in h.items()},
            "trans_err": float(torch.linalg.norm(tr.poses.trans[t]
                                                 - scene.gt_trans[t])),
            "rot_err_deg": rot_deg})
    # The opacity reset fires at iteration 50, the run's last mapping
    # iteration, clamping every opacity to 0.01: a render after the run
    # shows that reset, not the fit. The fit of frame 0 is its render that
    # the trainer cached after frame 0's last mapping iteration.
    psnr_cached = psnr(tr.state.pred_colors[0].float(), seq.colors[0])
    out_end = tr.render_frame(0)
    psnr_end = psnr(out_end["render"], seq.colors[0])
    losses = [f[k] for f in frames for k in ("loss", "rgb_loss", "flow_loss")
              if k in f]
    densify_events = sum(f.get("densify_events", 0) for f in frames)
    resets = sum(f.get("opacity_resets", 0) for f in frames)
    # every render of the run: tracking, both mapping views, the cache
    # render (each frame's history row), and the two render_frame(0) calls
    overflow = max([f["overflow"] for f in frames]
                   + [float(out_before["overflow"]),
                      float(out_end["overflow"])])
    phase("slice", t0, frames=frames, train_seconds=seconds,
          iterations=iters, iterations_per_s=iters / seconds,
          psnr_frame0_before=psnr_before,
          psnr_frame0_after_mapping=psnr_cached,
          psnr_frame0_end_of_run=psnr_end, overflow_max=overflow,
          launches=launches,
          expected_launches={"composite_fwd": exp_fwd,
                             "composite_bwd": exp_bwd},
          densify_events=densify_events, opacity_resets=resets,
          sh_degree=tr.active_sh_degree,
          active_gaussians=int(tr.field.num_active),
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          log=logs)
    check(all(math.isfinite(x) for x in losses + [psnr_end]),
          f"non-finite loss or PSNR {losses} {psnr_end}")
    check(psnr_cached > psnr_before,
          f"frame-0 PSNR did not improve: {psnr_before} -> {psnr_cached}")
    check(launches == {"composite_fwd": exp_fwd, "composite_bwd": exp_bwd},
          f"launches {launches} != renders made ({exp_fwd}, {exp_bwd})")
    check(overflow == 0, f"instance overflow {overflow}")
    check(densify_events >= 1, "densify never ran")
    check(resets >= 1, "the opacity reset never ran")
    check(tr.active_sh_degree == 3, "SH degree 3 not reached")
    for k in results["kernels"]:
        k["launches"] = launches[k["name"]]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "freesurgs_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: freesurgs_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # full f32 everywhere (SSIM's variance cancellation, the 3-NN matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    phase("device", t0, kind=kind, count=count, nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    from freesurgs_tpu_torch.ops import raster_cuda as rc
    t0 = time.time()
    reports = rc.build_kernels()
    ptxas = {}
    for name, rep in reports.items():
        regs = re.findall(r"Used (\d+) registers", rep)
        smem = re.findall(r"(\d+) bytes smem", rep)
        spill = re.findall(r"(\d+) bytes spill stores", rep)
        ptxas[name] = {"registers": [int(x) for x in regs],
                       "smem_bytes": [int(x) for x in smem],
                       "spill_store_bytes": [int(x) for x in spill]}
    phase("build", t0, built=sorted(reports), ptxas=ptxas)

    results: dict = {}
    parity_and_timing(dev, results)
    run_slice(dev, results)
    print(json.dumps({"kernels": results["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
