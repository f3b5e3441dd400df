#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (freesurgs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  1. device  — torch's device name and count, and nvidia-smi's name and
     power limit (also printed raw on a line of its own);
  2. build   — nvcc builds every kernel library from csrc/ (ptxas registers,
     shared memory and spills per kernel, each ablation variant included);
  3. ssim    — ``cli.ssim_probe`` at 1280x1024 with TF32 pinned off: its
     four checks against the float64 reference (ssim(x, x) = 1, the mean
     within 1e-4, the smallest denominator > 0, |ssim_map| <= 1 + 1e-3),
     and ``ops/ssim.ssim`` refusing to run with ``allow_tf32`` set;
  3b. project — the projection's kernels (``ops/project_cuda.py``,
     ``csrc/project.cu``) against their plain version on bench.py's scene
     recipe at the benchmark's 131,072 Gaussians (SH 3, 1280x1024, the last
     eighth unused zero-filled slots, a pose that is no identity): radius,
     tile rect and tiles touched bit-equal, the float outputs within
     PROJECT_FWD_TOL and every gradient (the Gaussians', the pose's, the
     probe's; and the pose's alone, as tracking asks) within
     PROJECT_GRAD_TOL of autograd through the plain version, both kernels
     bitwise equal over two launches, a render and its backward launching
     each once; device ms in a CUDA graph against the byte bound, stream
     and plain ms;
  4. parity  — K1, K2 (which stores each slot's gradients as one row of a
     sum-ordered (M, 10) buffer, row ``sum_rank[slot]``) and the
     per-Gaussian sum after K2 (``gaussian_grad_sum``, bitwise its plain
     version) against their plain PyTorch versions on bench.py's scene
     (100k Gaussians, SH3, 1280x1024, seed 0), and K2 launched twice on the
     same inputs (its outputs and their per-Gaussian sums bitwise equal);
     the sum also against ``index_add_`` over ``gather_idx``, the sum
     layout's runs against ``gather_idx`` itself and ``sum_rank`` against
     the inverse of ``sum_order``;
  5. timing  — CUDA-event times of K1 / K2 / the sum and their plain
     versions (the sum also beside ``index_add_``; both timed in a CUDA
     graph, since the sum is shorter than the host's time to launch it,
     and on the stream as before), with the pairs the records need, the
     least time the card could take (bound_ms) and the sum's run lengths;
  5b. prefix_parity + prefix_timing — the JAX default's reduction
     (``gaussian_grad_prefix``, grad_sum="prefix") on the bench scene
     binned with pre-slots: ``pre_rank`` a permutation of the slots with
     padding past the kept expansion, the runs [seg_lo, seg_hi) tiling the
     kept expansion, K2 writing at ``pre_rank`` twice and the kernel on its
     rows bitwise equal over launches and bitwise its plain version,
     within PREFIX_VS_DIRECT_TOL of the direct sum of the same rows (the
     difference printed); its device time (CUDA graph), stream time,
     plain time, ``torch.cumsum`` + the two lookups as the library's, and
     each of its kernels' launches a call and device time (torch.profiler;
     launches a call, the most of three one-call profiles, at most
     PREFIX_MAX_LAUNCHES); then layout "synthetic": the
     kernel on random rows at every PREFIX_LENGTHS count (0 to 5 levels,
     every block edge), runs with empty and one-row runs, two launches
     bitwise equal and bitwise its plain version, launches a call;
  6. ablate  — K3, the ablation family of today's K1 (ops/raster_ablate.py,
     one Hopper mechanism switched off a variant): the timing run over
     every variant on the bench scene, its launch counts read just after;
     then each variant against its plain version, ``baseline`` bit for bit
     against K1 and ``nobulk`` / ``rowmap`` against ``baseline``; then K1
     and K3 ``baseline`` timed in turns;
  7. slice   — the training job at 1280x1024 from 131,072 initial
     Gaussians, depth cut through TrainConfig: progressive SLAM with the
     default GN tracking (densify, the opacity reset at its last mapping
     iteration, SH degree 3), 40 global iterations with two validations
     and two periodic checkpoints, then save, restore into a fresh Trainer
     and 10 more global iterations there. Launch counters reset just before
     it and read just after. Frame 0's records at the end of the global
     stage are kept, and after the run K1 / K2 get phases 4 and 5 again on
     them (layout "slice_frame0": the main path's own shapes);
  7b. prefix — a Trainer with grad_sum="prefix" on the slice's scene:
     progressive SLAM and 10 global iterations, counters reset just before
     and read just after (K2 and the prefix reduction once a backward, the
     direct sum never), frame 0's PSNR rising with its mapping; then
     phase 5b again on frame 0's records (layout "slice_frame0");
  8. reuse   — the same scene with the binning-layout carry
     (rebin_every=4, rebin_tracking_every=5) and pose BA every 20 global
     iterations (5 Adam steps a frame): progressive SLAM, then 40 global
     iterations in two calls, a pose-BA pass ending each, and one
     validation. Counters reset just before and read just after: launches
     equal the renders made, binnings equal what the rebin schedule gives;
     every refined frame's loss at its returned pose is at most its loss at
     the pose it started from, and frame 0 and the test frame keep their
     poses bitwise. Then, on the trained map, frame 0 on its carried layout
     with nothing moved (bitwise the fresh render; gradients within K2's
     gate), and after one mapping step the stale render beside a fresh one
     (reported); and, per one-view mapping and per tracking iteration,
     the host syncs and the wall ms (in turns) binning every render and
     with the carry;
  9. overlap — progressive SLAM with keyframe_policy="overlap": finite
     losses, frame 0 fitted, launches equal the renders made, the keyframe
     views picked;
 10. cli     — the port's command line on the slice's scene written as a
     SCARED directory by ``save_synthetic_as_scared``: the PNG codec
     (frames decode to the arrays written, native un-filter = plain on
     frame 0, frame 0 forced to each filter type), the directory loaded
     raw and from the FSC1 cache the first load wrote (bitwise, K and
     poses to f32), ``cli.train`` at the slice's depth cut (files, the
     final validation row, panels, PLY = the final field's active rows),
     ``cli.train --run_test true --run_start_checkpoint latest`` (its
     validation = the final one) and ``cli.render --split all``; counters
     reset just before each command and read just after, launches = the
     renders made, panel renders included;
 11. raw     — from raw frames: ``make_nonrigid_scene`` at the full-res
     recipe cut to 6 frames, written as a SCARED directory without flow/
     and monodep/, ``cli.produce_inputs`` on the card (seconds per flow
     field; Horn-Schunck end-point error against the analytic flow on
     textured pixels, gated as the JAX producer test gates it; the
     parallax disparity's rank correlation with 1/depth, reported), frames
     0-1 produced again on the CPU (the same arrays within the CPU tests'
     tolerances), PnP on the analytic flow and rendered depth (frame 2
     within 0.01 of the truth), then a Trainer(pose_init="pnp")'s
     progressive stage, twice (counters reset just before each run and
     read just after, launches = renders made; the PnP and the
     constant-velocity init of frames 2-5 against the truth; the rigidity
     mask's precision and recall on the non-rigid pixels; the first render
     where the two runs differ, or none);
 12. fullres — ``cli.make_fullres_dataset`` at 1280x1024 cut to 10 frames,
     ``cli.run_config34`` (100 global iterations in chunks of 50, final
     pose BA), then ``--resume`` from its checkpoint at 50;
 13. tpu_rows — the recipe's first 6 frames (fullres's dataset) through
     ``cli.run_config34 --global_iters 0`` at cfg34_r5c's settings: each
     frame's flow_loss, rgb_loss and gn_resid_px beside cfg34_r5c's (the
     JAX package on a TPU v5e) and the recorded Arm A's (equal or not),
     and frame 1's beside tests/fullwidth_witness.py's (the JAX package
     and the port on the CPU at full width, iterations cut); every row
     finite; launches = renders;
 14. viz     — ``render_path`` over that map's camera paths, ``GSViewer`` on
     a stub server, a Trainer with a viewer for one chunk;
 15. bench   — the measuring and evaluation programs at their full default
     widths, each through its own ``run``: ``freesurgs_tpu_torch.bench``
     (bench.py's scene; the raw and the amortized rate, the amortized
     binnings ceil(iters / 4) a window), ``cli.bench_train_step`` with one
     view and with two (100k Gaussians), ``cli.stage_timing`` (the stages'
     kernel times, from the profiler, must rise from stage to stage; the
     CUDA-event and host times are printed) and ``cli.eval_ckpt``
     on fullres's ``ckpt_final`` (its validation = fullres's final one, the
     pose-refined test PSNR finite); each prints its JSON line with the
     card's name and power limit, counters reset just before each and read
     just after, launches = the renders it made. The bench's line carries
     ``step_costs``: a fresh step and the amortized window's binning and
     carried steps, each alone, with its host syncs, device ms and wall ms
     (in this warm process; ``python -m freesurgs_tpu_torch.bench`` gives
     the same in a fresh one);
 16. parallel — ``parallel/`` on torch.distributed: 2 ranks spawned on this
     card (gloo, since they share it), each rendering one band of 512 rows
     of the slice's scene through K1 / K2 / the sum. (a) the sharded render,
     with the projection replicated and sharded over N, against the
     single-process render; (b) ``mapping_chunk(mesh=)``,
     ``tracking_loop(mesh=)`` with GN and a ``Trainer(mesh=)`` progressive
     stage on 3 frames with 4 global iterations: the ranks' states bitwise
     equal, within the Trainer gate of a Trainer without a mesh, frame 0
     fitted; (c) ``multiseq_mapping_chunk`` on two sequences, one per rank,
     each bitwise its single-process run; (d) ms per sharded fwd+bwd per
     rank beside the single-process render; (e) grad_sum="prefix" on the
     bands (each band's prefix reduction, the sums all-reduced): (a)'s
     renders against the single-process "prefix" render (channels at the
     kernel gates, gradients within PREFIX_VS_DIRECT_TOL normalized: each
     band's prefix sum rounds otherwise), its launches = the bands'
     backwards, and a Trainer(mesh=) progressive stage raising frame 0's
     PSNR; the ranks bitwise equal throughout. Launch counters reset on
     every rank just before (a) and read just after (c), before the
     references;
 17. kernels — the launches by path, then one JSON line with every
     kernel's numbers (the projection's from phase 3b; K1 / K2 / the sum /
     the prefix reduction from the slice_frame0 layout,
     their launches summed over every path, the ranks' added for
     parallel; K3 from the bench scene);
then, last, {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, when there is no CUDA device or
the package is not beside this script; any failed check raises.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import io
import json
import math
import re
import subprocess
import sys
import tempfile
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
# logT += log1p(-alpha) (34), and in the backward's replay min(0.99, raw),
# w, cg, the running sum, dalpha, the per-pixel terms of the chain to the
# 10 fields and T *= 1 - alpha (58). The replay stops at each pixel's stop
# index, so no stopping pair reaches the backward's float work. Pairs whose
# rect misses the pixel (an integer test) or that come after the pixel's
# stop count 0, as do K2's per-record terms and warp reductions: the bound
# stays a lower bound.
FWD_OPS = {"cut": 14, "stopping": 19, "blended": 34}
BWD_OPS = {"cut": 14, "stopping": 0, "blended": 58}


def ablate_ops(mech) -> dict[str, int]:
    """FWD_OPS for an ablation variant: without the stop a blended pair
    skips the T (1 - alpha) test (3); with linear T it skips T = exp(logT)
    (1), the update T *= 1 - alpha costing what logT += log1p(-alpha) did.
    The rect tests are integer work either way."""
    ops = dict(FWD_OPS)
    if not mech.stop:
        ops["blended"] -= 3
    if mech.linear_t:
        ops["blended"] -= 1
        ops["stopping"] -= 1
    return ops


# Kernel vs plain tolerances. Both sum the same terms in another order
# (sequential f32 in the kernel, cumsum + einsum in the plain version), so
# outputs agree to f32 reassociation; the stop decisions compare
# T * (1 - alpha) with 1e-4, which reassociation can flip only for a pixel
# whose product lands within an ulp of the cutoff.
FWD_CHANNEL_TOL = 2e-5      # per channel, relative to max(1, |channel|)
FWD_STOP_DIFF_FRAC = 1e-4   # share of pixels whose stop index may differ
BWD_FIELD_TOL = 5e-5        # per-Gaussian gradient, normalized per field
#                             (the JAX package's oracle-vs-Pallas gate)
GN_MIN_WEIGHT = 64.0        # flow_pnp_refine's degenerate-frame guard

# The prefix reduction against the direct sum on the same K2 rows. The two
# reductions part by the rounding of one prefix sum over all M rows: JAX's
# fast binner against its own sort binner reads 3.77e-3 normalized on one
# 1280x1024 render (tests/fullwidth_witness.py, step 3), far past kernel
# parity's 5e-5, so this gate only catches a reduction of the wrong rows.
PREFIX_VS_DIRECT_TOL = 1e-2
PREFIX_GLOBAL = 10          # global iterations of the prefix Trainer run
# Synthetic row counts for the prefix kernel: 0 to 5 levels above the rows
# and every edge of its blocks of 16, its 256-row CTAs and its 4,096-row
# level-2 blocks; past ~1.2 million rows its third launch.
PREFIX_LENGTHS = (1, 15, 16, 17, 4095, 4096, 4097, 65537, 1048577, 1300000)
PREFIX_MAX_LAUNCHES = 3

# What each kernel of the training path replaces: K1, K2, the per-Gaussian
# sum after K2 (_composite_bwd's reduction with fast_binning=False) and,
# under grad_sum="prefix", its default fast_binning=True reduction.
MAIN_PATH_REPLACES = ("freesurgs_tpu/ops/raster_pallas.py:307",
                      "freesurgs_tpu/ops/raster_pallas.py:415",
                      "freesurgs_tpu/ops/raster_pallas.py:757")
PREFIX_REPLACES = "freesurgs_tpu/ops/raster_pallas.py:737"


def launch_counts(fwd: int, bwd: int, prefix: bool = False,
                  projections: int = 0, poses: int = 0) -> dict[str, int]:
    """The kernels' launches for ``fwd`` forward and ``bwd`` backward
    renders and ``projections`` projections outside a render
    (``render_records``, ``cli.stage_timing``'s first stages): each render
    projects once, each backward launches the projection's backward, K2,
    then the per-Gaussian sum, or with ``prefix`` (grad_sum="prefix") the
    prefix reduction; ``poses`` of the backwards take the pose's gradient
    (tracking, pose BA, pose refinement), each with the projection's pose
    reduction."""
    return {"composite_fwd": fwd, "composite_bwd": bwd,
            "gaussian_grad_sum": 0 if prefix else bwd,
            "gaussian_grad_prefix": bwd if prefix else 0,
            "project_fwd": fwd + projections, "project_bwd": bwd,
            "project_pose": poses}


def phase(name: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3),
                      **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def fwd_gates(out_k, out_p, H, W, name):
    """Per-channel errors of a forward-shaped kernel against its plain
    version, the stop-index differences, and the gate failures."""
    fails, ch_err = [], []
    for c in range(7):
        a, b = out_k[c, :H, :W], out_p[c, :H, :W]
        ch_err.append(float((a - b).abs().max()))
        scale = max(1.0, float(b.abs().max()))
        if not ch_err[-1] <= FWD_CHANNEL_TOL * scale:
            fails.append(f"{name} channel {c}: max abs err {ch_err[-1]} > "
                         f"{FWD_CHANNEL_TOL} x {scale}")
    stop_diff = int((out_k[7] != out_p[7]).sum())
    if not stop_diff <= FWD_STOP_DIFF_FRAC * out_k[7].numel():
        fails.append(f"{name}: {stop_diff} pixels stop at another instance")
    return ch_err, stop_diff, fails


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_F32_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def fwd_bytes(m: int, nt: int, gx: int, gy: int, bin_px: int) -> int:
    """feat and rect read once, starts / counts read and keff written, the
    (8, Hp, Wp) output written once."""
    return 4 * (10 * m + m + 3 * nt) + 8 * gy * bin_px * gx * bin_px * 4


def normalized_field_err(got, want) -> list[float]:
    """Per field: the largest |got - want| over Gaussians, over the
    largest |want|."""
    err = []
    for f in range(got.shape[1]):
        scale = max(float(want[:, f].abs().max()), 1e-12)
        err.append(float((got[:, f] - want[:, f]).abs().max()) / scale)
    return err


def run_lengths(seg) -> dict:
    """The sum's runs (slots per Gaussian): the longest, the mean, and the
    share of a warp's lane-steps that add a row when each of 32 lanes
    walks one run (a warp walks its longest)."""
    import torch
    lens = (seg[1:] - seg[:-1]).to(torch.int64)
    n = lens.shape[0]
    padded = torch.nn.functional.pad(lens, (0, -n % 32))
    steps = 32 * int(padded.view(-1, 32).amax(dim=1).sum())
    return {"max": int(lens.max()), "mean": float(lens.float().mean()),
            "warp_lane_efficiency": int(lens.sum()) / max(steps, 1)}


def kernel_checks(dev, layout: str, H: int, W: int, cfg, feat, rect, bins,
                  n: int) -> dict:
    """K1, K2 and the sum after K2 on one layout of binned records: each
    against its plain version under the gates, K2 twice on the same inputs
    (bitwise equal), then CUDA-event times of all three and of their plain
    versions, the pairs the records need and the bound. Prints the
    layout's ``parity`` and ``timing`` lines; returns {kernel name: its
    numbers}."""
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import cuda_graph_ms, cuda_ms

    t0 = time.time()
    gx, gy = cfg.grid_x, cfg.grid_y
    starts, counts, gidx = bins.tile_start, bins.tile_count, bins.gather_idx
    m = feat.shape[1]
    check(int(bins.overflow) == 0, f"{layout} overflowed: {bins.overflow}")

    out_k, keff_k = rc.composite_fwd(feat, rect, starts, counts, gx, gy)
    torch.cuda.synchronize()
    out_p, keff_p = rc.composite_fwd_plain(feat, rect, starts, counts, gx, gy)
    torch.cuda.synchronize()
    ch_err, stop_diff, fails = fwd_gates(out_k, out_p, H, W, "K1")
    keff_diff = int((keff_k != keff_p).sum())
    fwd_err = max(ch_err)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gout = torch.randn(out_k.shape, generator=gen, device=dev)
    gout[7] = 0.0
    gout[:, H:, :] = 0.0
    gout[:, :, W:] = 0.0
    order, seg, rank = bins.sum_order, bins.sum_start, bins.sum_rank
    dsum_k = rc.composite_bwd(feat, rect, starts, counts, keff_k, out_k,
                              gout, rank, gx, gy)
    dsum_k2 = rc.composite_bwd(feat, rect, starts, counts, keff_k, out_k,
                               gout, rank, gx, gy)
    # the per-Gaussian sums of both launches, by the fixed-order kernel
    gk = rc.gaussian_grad_sum(dsum_k, seg)
    gk2 = rc.gaussian_grad_sum(dsum_k2, seg)
    torch.cuda.synchronize()
    deterministic = torch.equal(dsum_k, dsum_k2)
    if not deterministic:
        fails.append("K2: two launches on the same inputs differ")
    sums_deterministic = torch.equal(gk, gk2)
    if not sums_deterministic:
        fails.append("K2 + gaussian_grad_sum: the per-Gaussian sums of two "
                     "launches differ")
    del dsum_k2, gk2
    # the sum kernel against its plain version (the same order: bitwise),
    # from 0 and seeded with sums to continue (a sharded render's bands)
    g_plain = rc.gaussian_grad_sum_plain(dsum_k, seg)
    sum_err = float((gk - g_plain).abs().max())
    sum_bitwise = torch.equal(gk, g_plain)
    if not sum_bitwise:
        fails.append(f"gaussian_grad_sum differs from its plain version by "
                     f"{sum_err}")
    seeded_bitwise = torch.equal(
        rc.gaussian_grad_sum(dsum_k, seg, init=g_plain),
        rc.gaussian_grad_sum_plain(dsum_k, seg, init=g_plain))
    if not seeded_bitwise:
        fails.append("gaussian_grad_sum seeded with sums differs from its "
                     "plain version")
    del g_plain
    dsum_p = rc.composite_bwd_plain(feat, rect, starts, counts, gout, rank,
                                    gx, gy)
    torch.cuda.synchronize()
    inst_err = float((dsum_k - dsum_p).abs().max())
    inst_scale = float(dsum_p.abs().max())
    gp = rc.gaussian_grad_sum_plain(dsum_p, seg)
    field_err = normalized_field_err(gk, gp)
    if not max(field_err) <= BWD_FIELD_TOL:
        fails.append(f"K2: normalized per-Gaussian gradient err {field_err}")
    # a witness independent of the sum layout built on the card: its runs
    # hold exactly the non-padding slots, sum_rank inverts sum_order (so
    # padding rows come last), and the kernel's sums agree with index_add_
    # over gather_idx of K2's rows put back in slot order
    held = gidx[order][:int(seg[-1])]
    layout_ok = torch.equal(held, torch.sort(gidx[gidx < n]).values)
    if not layout_ok:
        fails.append("sum layout: its runs are not the non-padding slots "
                     "of gather_idx grouped by Gaussian")
    rank_ok = torch.equal(rank[order.long()], torch.arange(
        m, dtype=torch.int32, device=dev))
    if not rank_ok:
        fails.append("sum layout: sum_rank is not the inverse of sum_order")
    g_lib = torch.zeros(n + 1, rc.N_FIELD, device=dev).index_add_(
        0, gidx, dsum_k[rank.long()])[:n]
    lib_err = normalized_field_err(gk, g_lib)
    if not max(lib_err) <= BWD_FIELD_TOL:
        fails.append(f"gaussian_grad_sum vs index_add_: normalized err "
                     f"{lib_err}")
    del held, g_lib
    phase("parity", t0, layout=layout, instances=m, tiles=gx * gy,
          fwd_max_abs_err_per_channel=ch_err, fwd_stop_index_diff=stop_diff,
          keff_diff=keff_diff, bwd_max_abs_err_per_instance=inst_err,
          bwd_max_abs_per_instance=inst_scale,
          bwd_normalized_err_per_field=field_err,
          bwd_bitwise_deterministic=deterministic,
          per_gaussian_sums_bitwise_deterministic=sums_deterministic,
          gaussian_grad_sum_vs_plain_max_abs_err=sum_err,
          gaussian_grad_sum_seeded_bitwise_plain=seeded_bitwise,
          sum_layout_is_gather_idx_grouped=layout_ok,
          sum_rank_is_inverse_of_sum_order=rank_ok,
          gaussian_grad_sum_vs_index_add_normalized_err_per_field=lib_err,
          tolerances={"fwd_channel": FWD_CHANNEL_TOL,
                      "fwd_stop_frac": FWD_STOP_DIFF_FRAC,
                      "bwd_field": BWD_FIELD_TOL,
                      "bwd_repeat": "bitwise equal",
                      "per_gaussian_sum_repeat": "bitwise equal",
                      "gaussian_grad_sum_vs_plain": "bitwise equal",
                      "gaussian_grad_sum_vs_index_add_": BWD_FIELD_TOL})
    check(not fails, f"{layout}: " + "; ".join(fails))
    del dsum_p, gk, gp, out_p

    t0 = time.time()
    ms_fwd = cuda_ms(lambda: rc.composite_fwd(feat, rect, starts, counts,
                                              gx, gy), iters=20)
    ms_bwd = cuda_ms(lambda: rc.composite_bwd(feat, rect, starts, counts,
                                              keff_k, out_k, gout, rank, gx,
                                              gy), iters=20)
    plain_fwd = cuda_ms(lambda: rc.composite_fwd_plain(
        feat, rect, starts, counts, gx, gy), iters=3, warmup=1)
    plain_bwd = cuda_ms(lambda: rc.composite_bwd_plain(
        feat, rect, starts, counts, gout, rank, gx, gy), iters=3, warmup=1)
    # the per-Gaussian sum: kernel, plain version, and index_add_ over each
    # row's Gaussian (the one PyTorch call that computes it, with atomics:
    # the library yardstick). The kernel is shorter than the host's time
    # to launch it, so it and index_add_ are timed in a CUDA graph (device
    # time); the stream-timed figure, the earlier method, stays beside them.
    sum_call = lambda: rc.gaussian_grad_sum(dsum_k, seg)  # noqa: E731
    row_gauss = gidx[order.long()]
    lib_call = lambda: torch.zeros(  # noqa: E731
        n + 1, rc.N_FIELD, device=dev).index_add_(0, row_gauss, dsum_k)
    ms_sum_stream = cuda_ms(sum_call, iters=20)
    ms_sum = cuda_graph_ms(sum_call, iters=20)
    lib_sum_stream = cuda_ms(lib_call, iters=20)
    lib_sum = cuda_graph_ms(lib_call, iters=20)
    plain_sum = cuda_ms(lambda: rc.gaussian_grad_sum_plain(dsum_k, seg),
                        iters=3, warmup=1)
    del dsum_k, row_gauss
    run_slots = int(seg[-1])
    # dsum's rows of the runs read once (40 B a slot), start read and out
    # written once
    sum_bytes = 4 * rc.N_FIELD * run_slots + 4 * (n + 1) \
        + 4 * rc.N_FIELD * n
    sum_ops = float(rc.N_FIELD * run_slots)
    # the pairs these records need, by kind, and the slots walked (every
    # pixel of a tile against its instances up to keff) for comparison
    pairs = rc.composite_pair_counts(feat, rect, starts, counts, gx)
    slots = float((torch.minimum(counts, keff_k * rc.CHUNK).to(torch.float64)
                   * rc.NPIX).sum())
    fwd_ops = float(sum(FWD_OPS[k] * v for k, v in pairs.items()))
    bwd_ops = float(sum(BWD_OPS[k] * v for k, v in pairs.items()))
    nt = gx * gy
    img = 8 * gy * rc.BIN * gx * rc.BIN * 4
    f_bytes = fwd_bytes(m, nt, gx, gy, rc.BIN)
    # feat and dsum, rect and sum_rank, starts / counts / keff, out and
    # gout (7 of 8 channels)
    bwd_bytes = 4 * (2 * rc.N_FIELD * m + 2 * m + 3 * nt) + 2 * img * 7 // 8
    rows = {}
    for name, ms, pms, ops, nbytes, err, lib in (
            ("composite_fwd", ms_fwd, plain_fwd, fwd_ops, f_bytes, fwd_err,
             None),
            ("composite_bwd", ms_bwd, plain_bwd, bwd_ops, bwd_bytes,
             inst_err, None),
            ("gaussian_grad_sum", ms_sum, plain_sum, sum_ops, sum_bytes,
             sum_err, lib_sum)):
        b_ms, b_by = bound(ops, nbytes)
        rows[name] = {"ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err,
                      "library_ms": lib}
    phase("timing", t0, layout=layout, instances=m, keff_sum=int(keff_k.sum()),
          pairs=pairs, pixel_slots_to_keff=slots, fwd_ops=fwd_ops,
          bwd_ops=bwd_ops, fwd_bytes=f_bytes, bwd_bytes=bwd_bytes,
          fwd_ms=ms_fwd, bwd_ms=ms_bwd, fwd_plain_ms=plain_fwd,
          bwd_plain_ms=plain_bwd,
          fwd_bound_ms=rows["composite_fwd"]["bound_ms"],
          bwd_bound_ms=rows["composite_bwd"]["bound_ms"],
          fwd_share_of_bound=rows["composite_fwd"]["bound_ms"] / ms_fwd,
          bwd_share_of_bound=rows["composite_bwd"]["bound_ms"] / ms_bwd,
          sum_ms=ms_sum, sum_plain_ms=plain_sum, sum_index_add_ms=lib_sum,
          sum_stream_timed_ms=ms_sum_stream,
          sum_index_add_stream_timed_ms=lib_sum_stream,
          sum_bytes=sum_bytes, sum_run_slots=run_slots,
          sum_run_lengths=run_lengths(seg),
          sum_bound_ms=rows["gaussian_grad_sum"]["bound_ms"],
          sum_share_of_bound=rows["gaussian_grad_sum"]["bound_ms"] / ms_sum,
          library_ms=None,
          library_note="no single PyTorch call computes K1 or K2; "
                       "index_add_ computes the per-Gaussian sum")
    return rows


def kernel_profile(fn, calls: int = 1) -> dict:
    """{kernel name: [launches a call, device us a launch]} of ``calls``
    calls of ``fn``, from torch.profiler's device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^\(anonymous namespace\)::", "", ev.key).split("(")[0]:
            [ev.count / calls, ev.self_device_time_total / ev.count]
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}


def launches_per_call(fn, tries: int = 3) -> int:
    """Kernel launches in one call of ``fn``: the most any of ``tries``
    one-call profiles shows (a profile can drop a call's events, never add
    one)."""
    return max(round(sum(c for c, _ in kernel_profile(fn).values()))
               for _ in range(tries))


def prefix_synthetic(dev) -> None:
    """The prefix kernel on synthetic rows at every PREFIX_LENGTHS count
    (f32 over ~8 decades, both signs), the runs a shuffled random tiling
    with empty and one-row runs: two launches bitwise equal and bitwise
    the plain version, its launches a call (torch.profiler) at most
    PREFIX_MAX_LAUNCHES. Prints ``prefix_parity`` with layout
    "synthetic"."""
    import numpy as np
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc

    t0 = time.time()
    cases, fails = [], []
    for m in PREFIX_LENGTHS:
        rng = np.random.default_rng(m)
        gen = torch.Generator(device=dev)
        gen.manual_seed(m)
        pre = torch.randn(m, rc.N_FIELD, generator=gen, device=dev) \
            * torch.exp(3.0 * torch.randn(m, 1, generator=gen, device=dev))
        one = rng.integers(0, m, 2)
        cuts = np.sort(np.concatenate([
            rng.integers(0, m + 1, max(8, m // 3)), [0, 0, m, m], one,
            one + 1]))
        order = rng.permutation(len(cuts) - 1)
        lo = torch.tensor(cuts[:-1][order], dtype=torch.int32, device=dev)
        hi = torch.tensor(cuts[1:][order], dtype=torch.int32, device=dev)
        a = rc.gaussian_grad_prefix(pre, lo, hi)
        b = rc.gaussian_grad_prefix(pre, lo, hi)
        plain = rc.gaussian_grad_prefix_plain(pre, lo, hi)
        torch.cuda.synchronize()
        prof = kernel_profile(lambda: rc.gaussian_grad_prefix(pre, lo, hi))
        launches = launches_per_call(
            lambda: rc.gaussian_grad_prefix(pre, lo, hi))
        case = {"m": m, "gaussians": int(lo.shape[0]),
                "levels": rc.scan_levels(m),
                "empty_runs": int((lo == hi).sum()),
                "bitwise_repeat": torch.equal(a, b),
                "bitwise_plain": torch.equal(a, plain),
                "max_abs_err": float((a - plain).abs().max()),
                "launches_per_call": launches, "kernels": sorted(prof)}
        cases.append(case)
        if not (case["bitwise_repeat"] and case["bitwise_plain"]):
            fails.append(f"M={m}: bitwise repeat {case['bitwise_repeat']}, "
                         f"plain {case['bitwise_plain']}")
        if not 1 <= launches <= PREFIX_MAX_LAUNCHES:
            fails.append(f"M={m}: {launches} launches a call")
        del pre, a, b, plain
    phase("prefix_parity", t0, layout="synthetic", cases=cases,
          tolerances={"vs_plain": "bitwise equal", "repeat": "bitwise equal",
                      "launches_per_call": PREFIX_MAX_LAUNCHES})
    check(not fails, "prefix synthetic: " + "; ".join(fails))


def prefix_checks(dev, layout: str, H: int, W: int, cfg, feat, rect, bins,
                  n: int) -> dict:
    """The prefix reduction (``gaussian_grad_prefix``) on one layout binned
    with pre-slots: ``pre_rank`` a permutation of the slots (padding past
    the kept expansion), the runs [seg_lo, seg_hi) tiling the kept
    expansion; K2 writing at ``pre_rank`` twice (bitwise equal), the kernel
    on both launches' rows and twice on the same rows (bitwise equal),
    bitwise its plain version, and within PREFIX_VS_DIRECT_TOL of the
    direct sum of K2's rows at ``sum_rank`` (the same rows, placed
    otherwise); then its device time (CUDA graph), stream time, plain time
    and the library yardstick's. Prints the layout's ``prefix_parity`` and
    ``prefix_timing`` lines; returns the kernel's numbers."""
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import cuda_graph_ms, cuda_ms

    t0 = time.time()
    gx, gy = cfg.grid_x, cfg.grid_y
    starts, counts, gidx = bins.tile_start, bins.tile_count, bins.gather_idx
    rank, lo, hi = bins.pre_rank, bins.seg_lo, bins.seg_hi
    m = feat.shape[1]
    kept = int(bins.num_instances)
    check(cfg.grad_sum == "prefix" and rank is not None,
          f"{layout}: not binned with pre-slots")
    check(int(bins.overflow) == 0, f"{layout} overflowed: {bins.overflow}")
    fails = []
    perm_ok = torch.equal(torch.sort(rank).values, torch.arange(
        m, dtype=torch.int32, device=dev))
    pad_ok = bool((rank[gidx == n] >= kept).all())
    if not (perm_ok and pad_ok):
        fails.append(f"pre_rank: permutation {perm_ok}, padding past the "
                     f"kept expansion {pad_ok}")
    runs = hi > lo
    order = torch.argsort(lo[runs])
    lo_r, hi_r = lo[runs][order], hi[runs][order]
    tile_ok = (int(lo_r[0]) == 0 and int(hi_r[-1]) == kept
               and torch.equal(lo_r[1:], hi_r[:-1]))
    if not tile_ok:
        fails.append("seg_lo / seg_hi do not tile the kept expansion")

    out_k, keff_k = rc.composite_fwd(feat, rect, starts, counts, gx, gy)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gout = torch.randn(out_k.shape, generator=gen, device=dev)
    gout[7] = 0.0
    gout[:, H:, :] = 0.0
    gout[:, :, W:] = 0.0
    pre = rc.composite_bwd(feat, rect, starts, counts, keff_k, out_k, gout,
                           rank, gx, gy)
    pre2 = rc.composite_bwd(feat, rect, starts, counts, keff_k, out_k, gout,
                            rank, gx, gy)
    gk = rc.gaussian_grad_prefix(pre, lo, hi)
    gk_again = rc.gaussian_grad_prefix(pre, lo, hi)
    gk2 = rc.gaussian_grad_prefix(pre2, lo, hi)
    torch.cuda.synchronize()
    repeat_ok = (torch.equal(pre, pre2) and torch.equal(gk, gk_again)
                 and torch.equal(gk, gk2))
    if not repeat_ok:
        fails.append("K2 at pre_rank + gaussian_grad_prefix: two launches "
                     "differ")
    del pre2, gk_again, gk2
    g_plain = rc.gaussian_grad_prefix_plain(pre, lo, hi)
    plain_err = float((gk - g_plain).abs().max())
    plain_ok = torch.equal(gk, g_plain)
    if not plain_ok:
        fails.append(f"gaussian_grad_prefix differs from its plain version "
                     f"by {plain_err}")
    del g_plain
    dsum = rc.composite_bwd(feat, rect, starts, counts, keff_k, out_k, gout,
                            bins.sum_rank, gx, gy)
    rows_ok = torch.equal(dsum[bins.sum_rank.long()], pre[rank.long()])
    if not rows_ok:
        fails.append("K2's rows at sum_rank and at pre_rank differ")
    direct = rc.gaussian_grad_sum(dsum, bins.sum_start)
    vs_direct = normalized_field_err(gk, direct)
    if not max(vs_direct) <= PREFIX_VS_DIRECT_TOL:
        fails.append(f"prefix vs direct sum: normalized err {vs_direct}")
    del dsum, direct
    phase("prefix_parity", t0, layout=layout, instances=m, kept=kept,
          levels=rc.scan_levels(m), pre_rank_is_permutation=perm_ok,
          padding_past_kept_expansion=pad_ok, runs_tile_expansion=tile_ok,
          bitwise_over_two_launches=repeat_ok,
          vs_plain_max_abs_err=plain_err, bitwise_plain=plain_ok,
          k2_rows_equal_at_both_ranks=rows_ok,
          vs_direct_normalized_err_per_field=vs_direct,
          tolerances={"vs_plain": "bitwise equal",
                      "repeat": "bitwise equal",
                      "vs_direct": PREFIX_VS_DIRECT_TOL})
    check(not fails, f"{layout} prefix: " + "; ".join(fails))

    t0 = time.time()
    call = lambda: rc.gaussian_grad_prefix(pre, lo, hi)  # noqa: E731
    lo_l, hi_l = lo.long(), hi.long()

    def lib_call():
        # torch.cumsum and the two lookups: the same function, not in the
        # JAX order (not bitwise)
        csum = torch.cat([pre.new_zeros(1, rc.N_FIELD),
                          torch.cumsum(pre, 0)])
        return csum[hi_l] - csum[lo_l]

    lib_err = float((lib_call() - gk).abs().max())
    per_kernel = kernel_profile(call, calls=10)
    launches = launches_per_call(call)
    ms = cuda_graph_ms(call, iters=20)
    ms_stream = cuda_ms(call, iters=20)
    lib_ms = cuda_graph_ms(lib_call, iters=20)
    plain_ms = cuda_ms(lambda: rc.gaussian_grad_prefix_plain(pre, lo, hi),
                       iters=3, warmup=1)
    # pre read once (40 B a row), seg_lo / seg_hi read and out written once;
    # at least one add an element of pre and one subtraction an output
    nbytes = 4 * rc.N_FIELD * m + 8 * n + 4 * rc.N_FIELD * n
    ops = float(rc.N_FIELD * (m + n))
    b_ms, b_by = bound(ops, nbytes)
    phase("prefix_timing", t0, layout=layout, instances=m, gaussians=n,
          ms=ms, stream_timed_ms=ms_stream, plain_ms=plain_ms,
          library_ms=lib_ms, library_max_abs_diff=lib_err,
          library_note="torch.cumsum over (M, 10) and the two lookups; "
                       "not the JAX order, not bitwise",
          bytes=nbytes, ops=ops, bound_ms=b_ms, bound_by=b_by,
          share_of_bound=b_ms / ms,
          per_kernel_launches_and_us=per_kernel, launches_per_call=launches)
    check(1 <= launches <= PREFIX_MAX_LAUNCHES,
          f"{layout} prefix: {launches} launches a call ({per_kernel})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": plain_err, "library_ms": lib_ms}


PROJECT_N = 131_072          # the benchmark's map: 131,072 Gaussians
# The projection kernels against their plain version on the card. The
# forward's floats are the plain ops' arithmetic where it decides an integer
# (radius, rect, tiles: bit-equal) and differ elsewhere only by the sum
# order of |p|^2 and eval_sh's contraction: within PROJECT_FWD_TOL of each
# field's largest magnitude. The gradients are autograd's chain summed in
# another order (the CPU tests hold the same two within 1e-6 in float32):
# within PROJECT_GRAD_TOL of each tensor's largest magnitude.
PROJECT_FWD_TOL = 1e-5
PROJECT_GRAD_TOL = 1e-5
PROJECT_REPLACES = ("none: XLA fuses the JAX projection "
                    "(freesurgs_tpu/ops/render.py:123-144)")
# the checks' pose (quaternion, translation): no identity, so that every
# product of mean_cam rounds
PROJECT_POSE = ((0.995, 0.03, -0.06, 0.04), (0.04, -0.02, 0.05))
# The edge scene, on the CPU in tests/test_torch_project_cuda.py and on the
# card in project_edge_checks: a 56x40 camera, 240 slots (the last 24
# unused), a pose, and the cases of the backward: name -> (the Gaussians
# need a gradient, the pose does, a probe, an active mask)
PROJECT_EDGE_CAM = dict(height=40, width=56, fx=50.0, fy=52.0, cx=28.0,
                        cy=20.0)
PROJECT_EDGE_N, PROJECT_EDGE_UNUSED = 240, 24
PROJECT_EDGE_POSE = ((0.98, 0.05, -0.1, 0.08), (0.05, -0.03, 0.1))
PROJECT_EDGE_CASES = {"mapping": (True, False, True, True),
                      "all": (True, True, True, False),
                      "tracking": (False, True, False, True)}


def project_dc_at_tie():
    """A DC coefficient x (float32) with fl(C0 x) = -0.5: the rgb
    channel's value before the clamp is then exactly 0 when its other
    coefficients are 0."""
    import numpy as np
    from freesurgs_tpu_torch.core.sh import C0
    x = np.float32(-0.5 / C0)
    for _ in range(64):
        p = np.float32(C0) * x
        if p == np.float32(-0.5):
            return x
        x = np.nextafter(x, np.float32(-np.inf if p > -0.5 else np.inf),
                         dtype=np.float32)
    raise AssertionError("no tie found")


def project_edge_scene(sh_degree: int, seed: int = 0, tie: bool = True):
    """PROJECT_EDGE_N slots as numpy arrays: live Gaussians in front of the
    camera, some behind the near cull, some far off-axis (the EWA clamp),
    inactive ones, and PROJECT_EDGE_UNUSED zero-filled unused slots at the
    end (zero means, identity quats); with ``tie`` the first Gaussian's red
    channel sits on the rgb clamp's tie. Returns ((means, quats,
    log_scales, logit_opacity, sh), active, probe, cotangents of mean2d,
    conic, rgbz and opacity, zero on the unused slots)."""
    import numpy as np
    n, rng = PROJECT_EDGE_N, np.random.default_rng(seed)
    k = max(16, (sh_degree + 1) ** 2)
    n_live = n - PROJECT_EDGE_UNUSED
    means = np.zeros((n, 3), np.float32)
    means[:n_live] = np.stack([rng.uniform(-0.8, 0.8, n_live),
                               rng.uniform(-0.6, 0.6, n_live),
                               rng.uniform(0.1, 3.0, n_live)], -1)
    means[:20, 0] *= 6.0                  # x / z beyond 1.3 tan(fov)
    means[20:40, 2] = rng.uniform(-0.5, 0.25, 20)   # some z <= 0.2
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    quats[:n_live] = rng.normal(size=(n_live, 4))
    ls = np.zeros((n, 3), np.float32)
    ls[:n_live] = np.log(rng.uniform(0.02, 0.2, (n_live, 3)))
    lo = np.zeros(n, np.float32)
    lo[:n_live] = rng.uniform(-3, 3, n_live)
    sh = np.zeros((n, k, 3), np.float32)
    sh[:n_live] = rng.normal(size=(n_live, k, 3)) * 0.4
    if tie:
        sh[0, :, 0] = 0.0
        sh[0, 0, 0] = project_dc_at_tie()
    active = (rng.uniform(size=n) > 0.1) & (np.arange(n) < n_live)
    probe = np.zeros((n, 2), np.float32)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((n, 2), (n, 3), (n, 4), (n,))]
    for c in cot:           # the rasterizer sends unused slots nothing
        c[n_live:] = 0.0
    return (means, quats, ls, lo, sh), active, probe, cot


def project_edge_checks(dev) -> dict:
    """``project_edge_scene`` on the card at SH degrees 0-4 (rows of 16
    coefficients, read 16 bytes at a time, below degree 4; of 25, read 4
    bytes at a time, at 4): per degree, the kernels' radius, rect and
    tiles against ``raster_inputs_plain``'s (mismatches), the float
    outputs' largest error, whether the plain rgb sits on the tie, and, in
    each of PROJECT_EDGE_CASES, every gradient's error against autograd
    through the plain version, whether all are finite, and whether the
    unused slots' are exactly zero. Errors are normalized by each tensor's
    largest magnitude, as in the CPU tests (the pose's quaternion and
    translation are a tensor each)."""
    import torch
    from freesurgs_tpu_torch.core.camera import Camera
    from freesurgs_tpu_torch.core.sh import eval_sh
    from freesurgs_tpu_torch.core.transforms import build_w2c
    from freesurgs_tpu_torch.ops import project_cuda as pc

    cam = Camera(**PROJECT_EDGE_CAM)
    n_live = PROJECT_EDGE_N - PROJECT_EDGE_UNUSED
    q0, t0 = (torch.tensor(v, device=dev) for v in PROJECT_EDGE_POSE)

    def err(got, want):
        scale = max(float(want.abs().max()), 1e-12)
        return float((got - want).abs().max()) / scale

    def grads(fn, ins, act, cot, deg, gs, pose, use_probe, use_active):
        leaves = [t.clone().requires_grad_(gs) for t in ins]
        q = q0.clone().requires_grad_(pose)
        t = t0.clone().requires_grad_(pose)
        p = (torch.zeros(PROJECT_EDGE_N, 2, device=dev, requires_grad=True)
             if use_probe else None)
        proj, rgbz, op = fn(*leaves, build_w2c(q, t), cam,
                            act if use_active else None, p, deg)
        visf = (proj.radius > 0).to(torch.float32)[:, None]
        loss = ((proj.mean2d * cot[0]).sum()
                + (proj.conic * cot[1] * visf).sum()
                + (rgbz * cot[2]).sum() + (op * cot[3]).sum())
        return torch.autograd.grad(
            loss, (leaves if gs else []) + ([q, t] if pose else [])
            + ([p] if use_probe else []))

    rows = {}
    for deg in range(5):
        arrays, active, probe, cot = project_edge_scene(deg, seed=deg + 1)
        ins = [torch.tensor(a, device=dev) for a in arrays]
        act = torch.tensor(active, device=dev)
        cot = [torch.tensor(c, device=dev) for c in cot]
        w2c = build_w2c(q0, t0)
        prb = torch.tensor(probe, device=dev) + 0.25
        with torch.no_grad():
            want, want_rgbz, want_op = pc.raster_inputs_plain(
                *ins, w2c, cam, act, prb, deg)
            m2, conic, rgbz, op, radius, rect, tiles = pc.project_fwd(
                *ins, w2c, cam, act, prb, deg)
            dirs = ins[0][:1] / torch.linalg.norm(ins[0][:1])
            v0 = float(eval_sh(deg, ins[4][:1], dirs)[0, 0] + 0.5)
        vis = want.radius > 0
        row = {"visible": int(vis.sum()),
               "int_mismatches": int(
                   (radius != want.radius).sum()
                   + (rect != want.tile_rect).any(1).sum()
                   + (tiles != want.tiles_touched).sum()),
               "fwd_err": max(err(m2, want.mean2d),
                              err(conic[vis], want.conic[vis]),
                              err(rgbz, want_rgbz), err(op, want_op)),
               "tie": v0 == 0.0 and float(rgbz[0, 0]) == 0.0,
               "grad_err": {}, "finite": True, "unused_zero": True}

        for case, flags in PROJECT_EDGE_CASES.items():
            got, ref = (grads(fn, ins, act, cot, deg, *flags) for fn in
                        (pc.raster_inputs, pc.raster_inputs_plain))
            row["grad_err"][case] = max(err(a, b) for a, b in zip(got, ref))
            row["finite"] &= all(bool(torch.isfinite(g).all()) for g in got)
            if flags[0]:
                row["unused_zero"] &= all(bool((g[n_live:] == 0).all())
                                          for g in got[:5])
        rows[deg] = row
    return rows


def project_scene(dev):
    """bench.py's scene recipe at the benchmark's 131,072 Gaussians (SH 3,
    1280x1024), its last eighth unused zero-filled slots (zero means,
    identity quaternions), as GaussianField pads them: (cam, params,
    active)."""
    import torch
    from freesurgs_tpu_torch.bench import bench_scene
    cam, params = bench_scene(dev, n=PROJECT_N)
    unused = PROJECT_N // 8
    for p in params:
        p[-unused:] = 0.0
    params[1][-unused:, 0] = 1.0
    active = torch.arange(PROJECT_N, device=dev) < PROJECT_N - unused
    return cam, params, active


def project_checks(dev) -> dict:
    """``ops/project_cuda.py``'s kernels against ``raster_inputs_plain`` on
    ``project_scene``: radius, rect and tiles bit-equal, the float outputs
    within PROJECT_FWD_TOL and every gradient (the Gaussians', the pose's
    through build_w2c, the probe's) within PROJECT_GRAD_TOL of autograd
    through the plain version; the pose alone (tracking) likewise; both
    kernels launched twice bitwise equal; a mapping ``render`` with its
    backward launching each kernel once, a tracking one the pose's
    reduction too; ``project_edge_checks`` held to the same gates; device
    ms (CUDA graph) against the byte bound, stream and plain ms. Prints
    ``project`` and returns its row."""
    import torch
    from freesurgs_tpu_torch.core.transforms import build_w2c
    from freesurgs_tpu_torch.ops import project_cuda as pc
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import cuda_graph_ms, cuda_ms
    from freesurgs_tpu_torch.ops.render import render

    t0 = time.time()
    cam, params, active = project_scene(dev)
    n, deg = PROJECT_N, 3
    q0, t0_ = (torch.tensor(v, device=dev) for v in PROJECT_POSE)
    w2c = build_w2c(q0, t0_)
    probe = torch.zeros(n, 2, device=dev)
    with torch.no_grad():
        want_p, want_rgbz, want_op = pc.raster_inputs_plain(
            *params, w2c, cam, active, probe, deg)
        got = pc.project_fwd(*params, w2c, cam, active, probe, deg)
        again = pc.project_fwd(*params, w2c, cam, active, probe, deg)
    mean2d, conic, rgbz, opac, radius, rect, tiles = got
    vis = want_p.radius > 0
    rect_mismatch = int((radius != want_p.radius).sum()
                        + (rect != want_p.tile_rect).any(1).sum()
                        + (tiles != want_p.tiles_touched).sum())

    def rel(a, b, rows=None):
        a, b = (a, b) if rows is None else (a[rows], b[rows])
        a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        return max(normalized_field_err(a, b))

    fwd_err = {"mean2d": rel(mean2d, want_p.mean2d),
               "conic": rel(conic, want_p.conic, vis),
               "rgbz": rel(rgbz, want_rgbz), "opacity": rel(opac, want_op)}
    pairs = {"mean2d": (mean2d, want_p.mean2d),
             "conic": (conic[vis], want_p.conic[vis]),
             "depth": (rgbz[:, 3], want_rgbz[:, 3]),
             "rgb": (rgbz[:, :3], want_rgbz[:, :3]),
             "opacity": (opac, want_op)}
    bit_share = {k: float((a == b).float().mean())
                 for k, (a, b) in pairs.items()}
    fwd_repeat = all(torch.equal(a, b) for a, b in zip(got, again))

    # gradients: kernel vs autograd through the plain version
    gen = torch.Generator(device=dev).manual_seed(5)
    cot = [torch.randn(s, generator=gen, device=dev)
           for s in ((n, 2), (n, 3), (n, 4), (n,))]
    for c in cot:
        c[~active] = 0.0
    visf = vis.to(torch.float32)[:, None]

    def grads(fn, gs: bool, pose: bool):
        leaves = [p.detach().requires_grad_(gs) for p in params]
        q = q0.clone().requires_grad_(pose)
        t = t0_.clone().requires_grad_(pose)
        prb = probe.clone().requires_grad_(gs)
        proj, rgbz_, op_ = fn(*leaves, build_w2c(q, t), cam, active, prb,
                              deg)
        loss = ((proj.mean2d * cot[0]).sum()
                + (proj.conic * cot[1] * visf).sum()
                + (rgbz_ * cot[2]).sum() + (op_ * cot[3]).sum())
        want = (leaves + [prb] if gs else []) + ([q, t] if pose else [])
        return torch.autograd.grad(loss, want)

    names = ["means", "quats", "log_scales", "logit_opacity", "sh", "probe",
             "pose_q", "pose_t"]
    g_k = grads(pc.raster_inputs, True, True)
    g_k2 = grads(pc.raster_inputs, True, True)
    g_p = grads(pc.raster_inputs_plain, True, True)
    grad_err = {k: grad_error(a, b) for k, a, b in zip(names, g_k, g_p)}
    t_k = grads(pc.raster_inputs, False, True)
    t_p = grads(pc.raster_inputs_plain, False, True)
    track_err = {k: grad_error(a, b)
                 for k, a, b in zip(names[-2:], t_k, t_p)}
    bwd_repeat = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))

    # launches of one render and its backward: mapping's (the Gaussians'
    # gradients) and tracking's (the pose's alone)
    keys = ("project_fwd", "project_bwd", "project_pose", "composite_fwd",
            "composite_bwd")
    leaves = [p.detach().requires_grad_(True) for p in params]
    rc.reset_launches()
    out = render(*leaves, w2c, cam, active=active, sh_degree=deg,
                 cam_grad=False)
    torch.autograd.grad(out["render"].sum(), leaves)
    torch.cuda.synchronize()
    launches = {k: rc.LAUNCHES[k] for k in keys}
    q = q0.clone().requires_grad_(True)
    t = t0_.clone().requires_grad_(True)
    rc.reset_launches()
    out = render(*params, build_w2c(q, t), cam, active=active, sh_degree=deg,
                 gs_grad=False, cam_grad=True)
    torch.autograd.grad(out["render"].sum(), (q, t))
    torch.cuda.synchronize()
    launches_pose = {k: rc.LAUNCHES[k] for k in keys}
    rc.reset_launches()
    edge = project_edge_checks(dev)

    # times: device (CUDA graph), stream, plain; the byte bound
    args = (*params, w2c, cam, active, probe, deg)
    bwd_args = (*params, w2c, cam, deg, *cot)
    ms_fwd = cuda_graph_ms(lambda: pc.project_fwd(*args), iters=20)
    ms_bwd = cuda_graph_ms(lambda: pc.project_bwd(*bwd_args, pose=False),
                           iters=20)
    ms_bwd_pose = cuda_graph_ms(lambda: pc.project_bwd(*bwd_args, gs=False),
                                iters=20)
    stream_fwd = cuda_ms(lambda: pc.project_fwd(*args), iters=20)
    stream_bwd = cuda_ms(lambda: pc.project_bwd(*bwd_args, pose=False),
                         iters=20)
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: pc.raster_inputs_plain(*args), iters=5)
    plain_fwd_bwd = cuda_ms(lambda: grads(pc.raster_inputs_plain, True,
                                          False), iters=5)
    k = params[4].shape[1]
    ins = 12 + 16 + 12 + 4 + 12 * k          # means, quats, scales, logit, SH
    fwd_bytes_ = n * (ins + 1 + 8 + 8 + 12 + 4 + 16 + 4 + 16 + 4)
    bwd_bytes_ = n * (ins + 8 + 12 + 16 + 4 + ins)
    fwd_bound, _ = bound(0, fwd_bytes_)
    bwd_bound, _ = bound(0, bwd_bytes_)
    row = {"gaussians": n, "sh_degree": deg, "visible": int(vis.sum()),
           "rect_mismatches": rect_mismatch, "fwd_err": fwd_err,
           "bit_equal_share": bit_share, "grad_err": grad_err,
           "tracking_grad_err": track_err,
           "bitwise_repeat": fwd_repeat and bwd_repeat,
           "render_launches": launches,
           "tracking_render_launches": launches_pose, "edge_scene": edge,
           "fwd_ms": ms_fwd, "bwd_ms": ms_bwd, "bwd_pose_only_ms": ms_bwd_pose,
           "fwd_stream_ms": stream_fwd, "bwd_stream_ms": stream_bwd,
           "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
           "fwd_share_of_bound": fwd_bound / ms_fwd,
           "bwd_share_of_bound": bwd_bound / ms_bwd,
           "plain_fwd_ms": plain_fwd, "plain_fwd_bwd_ms": plain_fwd_bwd,
           "bound_by": "bytes", "library_ms": None,
           "library_note": "no single PyTorch call computes the projection"}
    phase("project", t0, **row)
    check(rect_mismatch == 0,
          f"project: {rect_mismatch} radius / rect / tiles differ from plain")
    check(all(v <= PROJECT_FWD_TOL for v in fwd_err.values()),
          f"project forward: {fwd_err}")
    check(all(v <= PROJECT_GRAD_TOL for v in
              list(grad_err.values()) + list(track_err.values())),
          f"project gradients: {grad_err} {track_err}")
    check(fwd_repeat and bwd_repeat, "project: two launches differ")
    check(launches == {"project_fwd": 1, "project_bwd": 1, "project_pose": 0,
                       "composite_fwd": 1, "composite_bwd": 1},
          f"project: a render's launches {launches}")
    check(launches_pose == {"project_fwd": 1, "project_bwd": 1,
                            "project_pose": 1, "composite_fwd": 1,
                            "composite_bwd": 1},
          f"project: a tracking render's launches {launches_pose}")
    for d, e in edge.items():
        check(e["int_mismatches"] == 0 and e["tie"],
              f"project edge scene, SH {d}: {e}")
        check(e["fwd_err"] <= PROJECT_FWD_TOL
              and all(v <= PROJECT_GRAD_TOL for v in e["grad_err"].values())
              and e["finite"] and e["unused_zero"],
              f"project edge scene, SH {d}: {e}")
    return row


def run_prefix(dev, results) -> dict:
    """A Trainer with grad_sum="prefix" on the slice's scene: progressive
    SLAM, then PREFIX_GLOBAL global iterations. Launch counters reset just
    before it and read just after: K2 and the prefix reduction once a
    backward, the direct sum never; frame 0's PSNR rises with its mapping.
    Then ``prefix_checks`` on frame 0's records, and the kernel's row."""
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.render import render_records
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    scene, seq = slice_sequence(dev)
    cfg = TrainConfig(**SLICE_CFG, grad_sum="prefix")
    logs = []
    tr = Trainer(seq, cfg, log_fn=logs.append, device=dev, **SLICE_TRAINER)
    torch.cuda.synchronize()

    # ---- the main path, counters reset just before it
    rc.reset_launches()
    t_run = time.time()
    psnr_before = psnr(tr.render_frame(0)["render"], seq.colors[0])
    tr.progressive_run()
    psnr_cached = psnr(tr.state.pred_colors[0].float(), seq.colors[0])
    tr.global_run(PREFIX_GLOBAL)
    torch.cuda.synchronize()
    seconds = time.time() - t_run
    launches = dict(rc.LAUNCHES)
    # ---- end of the main path

    exp_fwd, exp_bwd, iters = progressive_counts(cfg, seq)
    exp_fwd += 1 + PREFIX_GLOBAL
    exp_bwd += PREFIX_GLOBAL
    losses = [h["loss"] for h in tr.history if "loss" in h]
    phase("prefix", t0, run_seconds=seconds, launches=launches,
          expected_launches=launch_counts(exp_fwd, exp_bwd, prefix=True,
                                          poses=tracking_renders(cfg, seq)),
          psnr_frame0_before=psnr_before,
          psnr_frame0_after_mapping=psnr_cached,
          global_losses=[h["loss"] for h in tr.history
                         if h["stage"] == "global"],
          active_gaussians=int(tr.field.num_active))
    check(all(math.isfinite(float(x)) for x in losses),
          f"prefix run: non-finite loss {losses}")
    check(launches == launch_counts(exp_fwd, exp_bwd, prefix=True,
                                    poses=tracking_renders(cfg, seq)),
          f"prefix run: launches {launches} != renders made "
          f"({exp_fwd}, {exp_bwd})")
    check(psnr_cached > psnr_before,
          f"prefix run: frame-0 PSNR did not improve: {psnr_before} -> "
          f"{psnr_cached}")

    fld = tr.field
    frame0 = render_records(fld.means, fld.quats, fld.log_scales,
                            fld.logit_opacity, fld.sh, tr.poses.w2c(0),
                            tr.cam, active=fld.active,
                            sh_degree=tr.active_sh_degree,
                            max_instances=tr.cfg.instance_cap,
                            grad_sum="prefix")
    row = prefix_checks(dev, "slice_frame0", tr.cam.height, tr.cam.width,
                        *frame0, fld.capacity)
    results["kernels"].append({
        "name": "gaussian_grad_prefix", "route": "cuda",
        "source": "freesurgs_tpu_torch/csrc/gaussian_grad_prefix.cu",
        "replaces": PREFIX_REPLACES, "launches": 0, **row})
    return {"prefix": launches}


# K3 variants that compute K1's function with K1's arithmetic per pair:
# baseline first, then those held to it bit for bit.
BITWISE_BASELINE = ("baseline", "nobulk", "rowmap")


def run_ssim(dev, smi: str) -> None:
    """``cli.ssim_probe`` at 1280x1024 on the card with TF32 pinned off (its
    four checks must pass), and ``ops/ssim.ssim`` refusing to run with
    ``allow_tf32`` set; the switch is restored after."""
    import torch
    from freesurgs_tpu_torch.cli import ssim_probe
    from freesurgs_tpu_torch.ops.ssim import ssim

    t0 = time.time()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are not pinned off")
    line = ssim_probe.run(ssim_probe.parse(["--device", str(dev)]))
    check(line["device"] == smi, f"ssim_probe device {line['device']}")
    x = torch.rand(3, 64, 64, device=dev)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ssim(x, x)
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    phase("ssim", t0, nvidia_smi=smi, probe=line, tf32_refused=refused)
    check(line["result"] == "PASS", f"ssim_probe failed: {line['checks']}")
    check(refused, "ssim ran with TF32 matmuls allowed")
    check(torch.backends.cuda.matmul.allow_tf32 == before,
          "the TF32 switch was not restored")


def run_ablate(bench, results):
    """K3's path (the ablation timing run, counted), then each variant
    against its plain version (not counted), ``baseline`` against K1 and
    ``nobulk`` / ``rowmap`` against ``baseline`` bit for bit, then K1 and
    K3 ``baseline`` (the same code) timed in turns."""
    import torch
    from freesurgs_tpu_torch.ops import raster_ablate as ra
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import cuda_ms

    t0 = time.time()
    cam, cfg, feat, rect, bins, _ = bench
    gx, gy = cfg.grid_x, cfg.grid_y
    args = (feat, rect, bins.tile_start, bins.tile_count, gx, gy)
    H, W = cam.height, cam.width

    ra.reset_launches()
    ms = ra.run_ablation(*args, iters=20)
    torch.cuda.synchronize()
    launches = dict(ra.LAUNCHES)

    m, nt = feat.shape[1], gx * gy
    nbytes = fwd_bytes(m, nt, gx, gy, rc.BIN)
    variants, fails, outs = {}, [], {}
    for name, mech in ra.VARIANTS.items():
        out_k, keff_k = ra.composite_fwd_ablate(name, *args)
        torch.cuda.synchronize()
        out_p, keff_p = ra.composite_fwd_ablate_plain(name, *args)
        torch.cuda.synchronize()
        ch_err, stop_diff, f = fwd_gates(out_k, out_p, H, W, f"K3 {name}")
        fails += f
        row = {"ms": ms[name], "minus_baseline_ms": ms[name] - ms["baseline"],
               "launches": launches[name], "max_abs_err_per_channel": ch_err,
               "stop_index_diff": stop_diff,
               "keff_diff": int((keff_k != keff_p).sum())}
        if name in BITWISE_BASELINE:
            outs[name] = (out_k, keff_k)
        pairs = ra.ablate_pair_counts(name, feat, rect, bins.tile_start,
                                      bins.tile_count, gx)
        ops = float(sum(ablate_ops(mech)[k] * v for k, v in pairs.items()))
        b_ms, b_by = bound(ops, nbytes)
        row.update(pairs=pairs, ops=ops, bound_ms=b_ms, bound_by=b_by,
                   share_of_bound=b_ms / ms[name])
        row["plain_ms"] = cuda_ms(lambda n=name: ra.composite_fwd_ablate_plain(
            n, *args), iters=2, warmup=1)
        variants[name] = row
        results["kernels"].append({
            "name": f"composite_fwd_ablate.{name}", "route": "cuda",
            "source": "freesurgs_tpu_torch/csrc/composite_fwd_ablate.cu",
            "replaces": "scripts/kernel_overhead.py:34",
            "launches": launches[name], "max_abs_err": max(ch_err),
            "ms": ms[name], "plain_ms": row["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    # baseline is K1's code; nobulk and rowmap change no pair's arithmetic
    ob, kb = outs["baseline"]
    k1_out, k1_keff = rc.composite_fwd(*args)
    bitwise = {"baseline_vs_k1": torch.equal(ob, k1_out)
               and torch.equal(kb, k1_keff)}
    for name in BITWISE_BASELINE[1:]:
        on, kn = outs[name]
        bitwise[f"{name}_vs_baseline"] = (torch.equal(ob, on)
                                          and torch.equal(kb, kn))
    fails += [f"K3 {k}: not bitwise equal" for k, v in bitwise.items()
              if not v]
    turns = {"k1_ms": [], "baseline_ms": []}
    for _ in range(2):
        turns["k1_ms"].append(cuda_ms(lambda: rc.composite_fwd(*args),
                                      iters=20))
        turns["baseline_ms"].append(cuda_ms(
            lambda: ra.composite_fwd_ablate("baseline", *args), iters=20))
    phase("ablate", t0, instances=m, variants=variants,
          bitwise_equal=bitwise, k1_vs_baseline=turns,
          tolerances={"fwd_channel": FWD_CHANNEL_TOL,
                      "fwd_stop_frac": FWD_STOP_DIFF_FRAC,
                      "baseline_vs_k1": "bitwise equal",
                      "nobulk_rowmap_vs_baseline": "bitwise equal"},
          library_note="no single PyTorch call computes these functions")
    check(not fails, "; ".join(fails))
    check(all(v > 0 for v in launches.values()),
          f"an ablation variant never launched: {launches}")


def psnr(img, gt) -> float:
    import torch
    mse = float(torch.mean((torch.clamp(img, 0, 1) - gt) ** 2))
    return -10.0 * math.log10(max(mse, 1e-12))


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


# The slice's depth cut (TrainConfig) and Trainer settings. The opacity
# reset fires at iteration 50, the last progressive mapping iteration;
# 40 global iterations (51-90) then fit the map again before a second
# reset could fire (100).
SLICE_CFG = dict(first_frame_mapping_iters=30, mapping_iters=10,
                 tracking_iters=10, densify_interval=40,
                 opacity_reset_interval=50, sh_increase_interval=10)
SLICE_TRAINER = dict(sh_degree_max=3, init_mask_frac=0.1, global_chunk=10)
VAL_KEYS = ("psnr", "ssim", "lpips", "ate", "rpe_trans", "rpe_rot_deg")


def slice_sequence(dev, n_frames: int = 4, seed: int = 7):
    """scripts/make_fullres_dataset.py's recipe, 4 frames at 1280x1024.
    Frame 1 is a test frame: tracked and rendered into the depth cache
    (which frame 2's flow loss and GN solve read), not mapped."""
    from freesurgs_tpu_torch.data.synthetic import SceneSequence, make_scene
    scene = make_scene(num_frames=n_frames, n_gaussians=20000, height=1024,
                       width=1280, seed=seed, scale_range=(0.004, 0.012),
                       device=dev)
    seq = SceneSequence(scene, i_test=[1])
    seq.gt_poses = {"synthetic": scene.gt_w2c.cpu().numpy()}
    seq.boundaries = [0, n_frames]
    return scene, seq


def progressive_counts(cfg, seq) -> tuple[int, int, int]:
    """Forward and backward renders, and optimizer iterations, of
    ``progressive_run``: tracking on every frame but 0, one cache render of
    a test frame, one view on frame 0's mapping and two on the others'."""
    n_frames = int(seq.colors.shape[0])
    train = set(int(t) for t in seq.i_train)
    fwd = bwd = iters = 0
    for t in range(n_frames):
        if t > 0:
            fwd += cfg.tracking_iters
            bwd += cfg.tracking_iters
            iters += cfg.tracking_iters
        if t not in train:
            fwd += 1                      # the test frame's cache render
        elif t == 0:
            fwd += cfg.first_frame_mapping_iters
            bwd += cfg.first_frame_mapping_iters
            iters += cfg.first_frame_mapping_iters
        else:
            fwd += 2 * cfg.mapping_iters
            bwd += 2 * cfg.mapping_iters
            iters += cfg.mapping_iters
    return fwd, bwd, iters


def tracking_renders(cfg, seq) -> int:
    """The renders of ``progressive_run`` whose backward takes the pose's
    gradient: tracking's, on every frame but 0."""
    return (int(seq.colors.shape[0]) - 1) * cfg.tracking_iters


def carried_bins(frames, it0: int, cfg) -> int:
    """Renders of one carried view of a mapping chunk that bin, by the
    rebin rule: force | a new frame | k % rebin_every == 0, with force
    true at k = 0 and after an iteration with a densify event or an
    opacity reset (global iteration it0 + k + 1)."""
    n, prev, force = 0, None, True
    for k, t in enumerate(frames):
        n += bool(force or t != prev or k % cfg.rebin_every == 0)
        prev, it = t, it0 + k + 1
        force = ((it % cfg.densify_interval == 0 and it < cfg.densify_until)
                 or it % cfg.opacity_reset_interval == 0)
    return n


def run_slice(dev, results, ckpt_root: Path):
    import torch
    from freesurgs_tpu_torch.core.transforms import quat_to_rotmat
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import cuda_ms
    from freesurgs_tpu_torch.ops.render import render_records
    from freesurgs_tpu_torch.train.flow_pnp import flow_pnp_refine
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    scene, seq = slice_sequence(dev)
    n_frames = scene.colors.shape[0]
    cfg = TrainConfig(**SLICE_CFG)
    ckpt_dir = ckpt_root / "run"
    tkw = dict(SLICE_TRAINER, device=dev, validation_every=20,
               checkpoint_every=20, checkpoint_dir=str(ckpt_dir))
    logs = []
    tr = Trainer(seq, cfg, log_fn=logs.append, **tkw)
    torch.cuda.synchronize()
    phase("slice_setup", t0, init_gaussians=int(tr.field.num_active),
          capacity=tr.field.capacity, log=logs[:])
    check(int(tr.field.num_active) == 131_072, "expected 131,072 Gaussians")
    logs.clear()

    # ---- the main path, counters reset just before it
    rc.reset_launches()
    rc.reset_bins()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.time()
    renders = 0                     # render_frame / validation calls below
    out_before = tr.render_frame(0)
    renders += 1
    psnr_before = psnr(out_before["render"], seq.colors[0])
    tr.progressive_run()
    torch.cuda.synchronize()
    prog_seconds = time.time() - t_run
    out_reset = tr.render_frame(0)
    renders += 1
    psnr_post_reset = psnr(out_reset["render"], seq.colors[0])
    psnr_cached = psnr(tr.state.pred_colors[0].float(), seq.colors[0])

    t1 = time.time()
    tr.global_run(40)
    torch.cuda.synchronize()
    global_seconds = time.time() - t1
    out_end = tr.render_frame(0)
    renders += 1
    psnr_end = psnr(out_end["render"], seq.colors[0])
    # the records of that render (binning only, no kernel launch), for
    # checking and timing K1 / K2 at the path's own shapes after the run
    fld = tr.field
    frame0 = render_records(fld.means, fld.quats, fld.log_scales,
                            fld.logit_opacity, fld.sh, tr.poses.w2c(0),
                            tr.cam, active=fld.active,
                            sh_degree=tr.active_sh_degree,
                            max_instances=tr.cfg.instance_cap)
    n_frame0 = fld.capacity
    t1 = time.time()
    val = tr.validation()
    torch.cuda.synchronize()
    val_seconds = time.time() - t1
    renders += len(seq.i_test)

    # save, restore into a fresh Trainer, compare, continue there
    t1 = time.time()
    tr.save(str(ckpt_root / "ckpt_final"))
    save_seconds = time.time() - t1
    fresh = Trainer(seq, cfg, log_fn=logs.append, **tkw)
    torch.cuda.synchronize()
    t1 = time.time()
    fresh.restore(str(ckpt_root / "ckpt_final"))
    torch.cuda.synchronize()
    restore_seconds = time.time() - t1
    fields_equal = all(torch.equal(getattr(tr.field, k),
                                   getattr(fresh.field, k))
                       for k in ("means", "quats", "log_scales",
                                 "logit_opacity", "sh_dc", "sh_rest",
                                 "active", "max_radii2d", "grad_accum",
                                 "grad_denom"))
    poses_equal = (torch.equal(tr.poses.quats, fresh.poses.quats)
                   and torch.equal(tr.poses.trans, fresh.poses.trans))
    render_equal = torch.equal(tr.render_frame(0)["render"],
                               fresh.render_frame(0)["render"])
    renders += 2
    done_before = fresh._global_done
    t1 = time.time()
    fresh.global_run(10)
    torch.cuda.synchronize()
    resumed_seconds = time.time() - t1
    seconds = time.time() - t_run
    launches = dict(rc.LAUNCHES)
    bins = rc.BINS["build_tile_bins"]
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path

    prog = [h for h in tr.history if h["stage"] == "progressive"]
    glob = [h for h in tr.history if h["stage"] == "global"]
    vals = [h for h in tr.history if h["stage"] == "global_val"]
    exp_fwd, exp_bwd, iters = progressive_counts(cfg, seq)
    exp_fwd += renders
    global_iters = 40 + 10
    exp_fwd += global_iters + len(vals) * len(seq.i_test)
    exp_bwd += global_iters

    frames = []
    for h in prog:
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

    # GN's cost on one tracked frame's inputs (frame 2, from frame 1's cache)
    rigid = tr._rigid_mask(2)
    with torch.no_grad():
        prev_w2c = tr.poses.w2c(1)
    gn_ms = cuda_ms(lambda: flow_pnp_refine(
        tr.poses.quats[2], tr.poses.trans[2], tr.state.pred_depths[1],
        prev_w2c, tr.flows_fw[1], tr.cam, rigid_mask=rigid,
        iters=cfg.tracking_gn_iters), iters=5, warmup=1)

    losses = [f[k] for f in frames for k in ("loss", "rgb_loss", "flow_loss")
              if k in f] + [h["loss"] for h in glob]
    densify_events = sum(f.get("densify_events", 0) for f in frames)
    resets = sum(f.get("opacity_resets", 0) for f in frames)
    # every render of the run: tracking, both mapping views, the cache
    # render, the global stage, validation and the render_frame calls
    overflow = max([f["overflow"] for f in frames]
                   + [h["overflow"] for h in glob + vals]
                   + [float(o["overflow"]) for o in
                      (out_before, out_reset, out_end)]
                   + [val["overflow"]])
    ckpts = sorted(p.name for p in ckpt_dir.iterdir() if p.is_dir())
    ckpt_bytes = dir_bytes(ckpt_root / "ckpt_final")
    gn_weights = [f["gn_weight"] for f in frames if "gn_weight" in f]
    phase("slice", t0, frames=frames, run_seconds=seconds,
          progressive_seconds=prog_seconds, progressive_iterations=iters,
          progressive_iterations_per_s=iters / prog_seconds,
          global_seconds=global_seconds, global_iterations=40,
          global_iterations_per_s_with_val_and_ckpt=40 / global_seconds,
          resumed_global_seconds=resumed_seconds,
          resumed_global_iterations_per_s=10 / resumed_seconds,
          gn_ms_per_frame=gn_ms, gn_weight=gn_weights,
          gn_resid_px=[f["gn_resid_px"] for f in frames
                       if "gn_resid_px" in f],
          validation_seconds=val_seconds,
          validation={k: val[k] for k in VAL_KEYS + ("lpips_backend",)},
          global_validations=[{k: h.get(k) for k in ("iter",) + VAL_KEYS}
                              for h in vals],
          checkpoints=ckpts, checkpoint_bytes=ckpt_bytes,
          save_seconds=save_seconds, restore_seconds=restore_seconds,
          restore={"fields_equal": fields_equal, "poses_equal": poses_equal,
                   "keyframes_equal": fresh.keyframes == tr.keyframes,
                   "render_frame0_bitwise_equal": render_equal,
                   "global_done_before_resume": done_before,
                   "global_done_after_resume": fresh._global_done},
          psnr_frame0_before=psnr_before,
          psnr_frame0_after_mapping=psnr_cached,
          psnr_frame0_post_reset=psnr_post_reset,
          psnr_frame0_end_of_run=psnr_end,
          global_losses=[h["loss"] for h in glob], overflow_max=overflow,
          launches=launches,
          expected_launches=launch_counts(exp_fwd, exp_bwd, projections=1,
                                          poses=tracking_renders(cfg, seq)),
          binnings=bins, binnings_per_render=bins / exp_fwd,
          densify_events=densify_events, opacity_resets=resets,
          sh_degree=tr.active_sh_degree,
          active_gaussians=int(tr.field.num_active),
          max_memory_allocated=peak, log=logs)
    check(all(math.isfinite(x) for x in losses + [psnr_end]),
          f"non-finite loss or PSNR {losses} {psnr_end}")
    check(all(math.isfinite(f[k]) for f in frames
              for k in ("trans_err", "rot_err_deg")),
          "non-finite pose error")
    # every tracked frame's previous frame has a depth cache here (frame
    # 0's prior, frame 1's test-frame render, frame 2's mapping)
    check(len(gn_weights) == n_frames - 1
          and all(w >= GN_MIN_WEIGHT for w in gn_weights),
          f"GN fell back to the init: weights {gn_weights}")
    check(psnr_cached > psnr_before,
          f"frame-0 PSNR did not improve: {psnr_before} -> {psnr_cached}")
    check(psnr_end > psnr_post_reset,
          f"the global stage did not fit frame 0 again after the reset: "
          f"{psnr_post_reset} -> {psnr_end}")
    check([h["iter"] for h in vals] == [20, 40]
          and all(math.isfinite(h[k]) for h in vals for k in VAL_KEYS)
          and val["lpips_backend"] in ("weights", "random_features"),
          f"validation rows {vals}")
    check(ckpts == ["ckpt_0000020", "ckpt_0000040"],
          f"periodic checkpoints {ckpts}")
    check(fields_equal and poses_equal and render_equal
          and fresh.keyframes == tr.keyframes,
          "the restored Trainer differs from the saved one")
    check(done_before == 40 and fresh._global_done == 50,
          f"global counter {done_before} -> {fresh._global_done}")
    check(launches == launch_counts(exp_fwd, exp_bwd, projections=1,
                                    poses=tracking_renders(cfg, seq)),
          f"launches {launches} != renders made ({exp_fwd}, {exp_bwd})")
    # every render bins, and so does render_records
    check(bins == exp_fwd + 1, f"binnings {bins} != {exp_fwd} renders + 1")
    check(overflow == 0, f"instance overflow {overflow}")
    check(densify_events >= 1, "densify never ran")
    check(resets >= 1, "the opacity reset never ran")
    check(tr.active_sh_degree == 3, "SH degree 3 not reached")

    # K1 / K2 on frame 0's render at the end of the global stage
    rows = kernel_checks(dev, "slice_frame0", tr.cam.height, tr.cam.width,
                         *frame0, n_frame0)
    results["kernels"][:0] = [{
        "name": name, "route": "cuda",
        "source": f"freesurgs_tpu_torch/csrc/{name}.cu", "replaces": rep,
        "launches": launches[name], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for (name, r), rep in zip(rows.items(), MAIN_PATH_REPLACES)]
    return {"progressive_iterations_per_s": iters / prog_seconds,
            "global_iterations_per_s_with_val_and_ckpt": 40 / global_seconds,
            "resumed_global_iterations_per_s": 10 / resumed_seconds,
            "launches": launches,
            "binnings_per_render": bins / exp_fwd,
            "max_memory_allocated": peak,
            "validation": {k: val[k] for k in VAL_KEYS}}


def frame_loss(tr, t: int, quat, trans) -> float:
    """Frame t's photometric loss at a pose, as the pose-BA pass measures
    it (unmasked rgb_loss of a forward render)."""
    import torch
    from freesurgs_tpu_torch.core.transforms import build_w2c
    from freesurgs_tpu_torch.ops.render import render
    from freesurgs_tpu_torch.train import losses
    f = tr.field
    with torch.no_grad():
        out = render(f.means, f.quats, f.log_scales, f.logit_opacity, f.sh,
                     build_w2c(quat, trans), tr.cam, active=f.active,
                     sh_degree=tr.active_sh_degree,
                     max_instances=tr.cfg.instance_cap, gs_grad=False)
        return float(losses.rgb_loss(out["render"], tr.colors[t]))


def carry_exactness(tr) -> dict:
    """(a) of the reuse phase, on a trained Trainer: frame 0 rendered fresh
    with a carry and again on the carried layout with the same parameters
    (outputs bitwise equal, per-Gaussian gradients within the K2 gate:
    index_add_ sums in a varying order); then one mapping step, and the
    stale layout's render beside a fresh one (reported, no gate: the
    sliver of Gaussians that grew or moved beyond their binned bins)."""
    import torch
    from freesurgs_tpu_torch.ops.render import render
    from freesurgs_tpu_torch.train import losses
    from freesurgs_tpu_torch.train.steps import mapping_chunk

    names = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
             "sh_rest")
    f = tr.field
    w2c0 = tr.poses.w2c(0).detach()

    def rend(field, bins, rebin, grad=False):
        p = {k: getattr(field, k).detach().requires_grad_(grad)
             for k in names}
        out = render(p["means"], p["quats"], p["log_scales"],
                     p["logit_opacity"],
                     torch.cat([p["sh_dc"], p["sh_rest"]], dim=1), w2c0,
                     tr.cam, active=field.active,
                     sh_degree=tr.active_sh_degree,
                     max_instances=tr.cfg.instance_cap, bins=bins,
                     rebin=rebin)
        if not grad:
            return out, None
        loss = (losses.rgb_loss(out["render"], tr.colors[0])
                + 0.05 * losses.pearson_depth_loss(tr.monodeps[0],
                                                   out["render_dep"]))
        return out, torch.autograd.grad(loss, [p[k] for k in names])

    o1, g1 = rend(f, None, True, grad=True)
    o2, g2 = rend(f, o1["bins"], False, grad=True)
    torch.cuda.synchronize()
    bitwise = {k: torch.equal(o1[k], o2[k])
               for k in ("render", "render_dep", "render_sil", "final_T")}
    grad_err = {}
    for k, a, b in zip(names, g1, g2):
        scale = max(float(a.abs().max()), 1e-12)
        grad_err[k] = float((a - b).abs().max()) / scale
    with torch.no_grad():
        w2c_all = tr.poses.all_w2c()
    tr.state, _ = mapping_chunk(tr.state, tr.colors, tr.monodeps, w2c_all,
                                [0], [], tr.cam, tr.cfg, two_views=False,
                                sh_degree=tr.active_sh_degree,
                                densify_enabled=False)
    with torch.no_grad():
        stale, _ = rend(tr.field, o1["bins"], False)
        fresh, _ = rend(tr.field, None, None)
    diff = (stale["render"] - fresh["render"]).abs()
    res = {"bitwise_equal": bitwise, "grad_normalized_err": grad_err,
           "instances": int(o1["num_instances"]),
           "after_one_step": {
               "max_abs_diff_render": float(diff.max()),
               "max_abs_diff_final_T": float(
                   (stale["final_T"] - fresh["final_T"]).abs().max()),
               "pixel_share_differing": float(
                   (diff.amax(dim=0) > 0).to(torch.float32).mean()),
               # beyond the rounding of a re-chunked run: the sliver
               "pixel_share_differing_over_1e-5": float(
                   (diff.amax(dim=0) > 1e-5).to(torch.float32).mean()),
               "pixel_share_differing_over_1e-3": float(
                   (diff.amax(dim=0) > 1e-3).to(torch.float32).mean()),
               "instances_fresh": int(fresh["num_instances"])}}
    check(all(bitwise.values()), f"reuse with nothing moved differs: {bitwise}")
    check(max(grad_err.values()) <= BWD_FIELD_TOL,
          f"reuse gradients differ: {grad_err}")
    return res


def iteration_costs(tr, n: int = 8, every_n: int = 4) -> dict:
    """Host syncs and wall ms per one-view mapping iteration on frame 0 and
    per tracking (Adam) iteration, binning on every render and with the
    layout carried (rebin every ``every_n``), over chunks of ``n``
    iterations: the syncs first (their run warms both), then the wall
    times in turns (every, carried, carried, every). What skipping the
    binner takes off the host's critical path. Mapping without densify;
    the state moves on."""
    import torch
    from freesurgs_tpu_torch.train.steps import mapping_chunk, tracking_loop
    from freesurgs_tpu_torch.utils.profiling import count_syncs

    def mapping(cfg):
        def fn():
            w2c = tr.poses.all_w2c().detach()
            tr.state, _ = mapping_chunk(
                tr.state, tr.colors, tr.monodeps, w2c, [0] * n, [], tr.cam,
                cfg, two_views=False, sh_degree=tr.active_sh_degree,
                densify_enabled=False)
        return fn

    def tracking(cfg):
        rigid = tr._rigid_mask(2)
        prev_w2c = tr.poses.w2c(1).detach()
        return lambda: tracking_loop(
            tr.field, tr.poses.quats[2], tr.poses.trans[2], tr.colors[2],
            tr.state.pred_depths[1], prev_w2c, tr.flows_fw[1], rigid, tr.cam,
            cfg._replace(tracking_iters=n, tracking_gn_iters=0),
            sh_degree=tr.active_sh_degree)

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3 / n

    keys = ("bin_every_render", f"rebin_every_{every_n}")
    cfgs = (tr.cfg._replace(rebin_every=1, rebin_tracking_every=1),
            tr.cfg._replace(rebin_every=every_n,
                            rebin_tracking_every=every_n))
    out = {}
    for name, make in (("mapping_one_view", mapping),
                       ("tracking_adam", tracking)):
        fns = dict(zip(keys, (make(c) for c in cfgs)))
        row = {"host_syncs": {k: count_syncs(f) / n for k, f in fns.items()},
               "wall_ms_in_turns": {k: [] for k in keys}}
        for k in (keys[0], keys[1], keys[1], keys[0]):
            row["wall_ms_in_turns"][k].append(wall_ms(fns[k]))
        out[name] = row
    return out


def run_reuse(dev, slice_summary: dict):
    """The layout carry and pose BA at full width: (b) a training run with
    rebin_every=4, rebin_tracking_every=5 and pose BA every 20 global
    iterations (counters reset just before it, read just after), then (a)
    carry_exactness on the trained map."""
    import numpy as np
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    _, seq = slice_sequence(dev)
    cfg = TrainConfig(**SLICE_CFG, rebin_every=4, rebin_tracking_every=5)
    logs = []
    tr = Trainer(seq, cfg, log_fn=logs.append, device=dev,
                 validation_every=0, pose_ba_every=20, pose_ba_iters=5,
                 **SLICE_TRAINER)
    check(int(tr.field.num_active) == 131_072, "expected 131,072 Gaussians")
    train = [int(t) for t in seq.i_train]
    refined = [t for t in train if t != 0]
    pinned = [t for t in range(len(seq.colors)) if t not in refined]

    # ---- this path, counters reset just before it
    rc.reset_launches()
    rc.reset_bins()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.time()
    renders = 0                     # forward-only renders made here
    out_before = tr.render_frame(0)
    renders += 1
    psnr_before = psnr(out_before["render"], seq.colors[0])
    tr.progressive_run()
    torch.cuda.synchronize()
    prog_seconds = time.time() - t_run
    out_reset = tr.render_frame(0)
    renders += 1
    psnr_post_reset = psnr(out_reset["render"], seq.colors[0])
    psnr_cached = psnr(tr.state.pred_colors[0].float(), seq.colors[0])
    poses_global0 = (tr.poses.quats.clone(), tr.poses.trans.clone())
    global_seconds, ba_checks = 0.0, []
    for _ in range(2):              # pose BA at the end of each call
        q0, t0_ = tr.poses.quats.clone(), tr.poses.trans.clone()
        t1 = time.time()
        tr.global_run(20)
        torch.cuda.synchronize()
        global_seconds += time.time() - t1
        for t in refined:
            start = frame_loss(tr, t, q0[t], t0_[t])
            ret = frame_loss(tr, t, tr.poses.quats[t], tr.poses.trans[t])
            ba_checks.append({"iter": tr._global_done, "frame": t,
                              "loss_start": start, "loss_returned": ret})
        renders += 2 * len(refined)
    out_end = tr.render_frame(0)
    renders += 1
    psnr_end = psnr(out_end["render"], seq.colors[0])
    val = tr.validation()
    renders += len(seq.i_test)
    torch.cuda.synchronize()
    seconds = time.time() - t_run
    launches = dict(rc.LAUNCHES)
    bins = rc.BINS["build_tile_bins"]
    peak = torch.cuda.max_memory_allocated()
    # ---- end of this path

    # what the schedule says: renders and binnings
    exp_fwd, exp_bwd, iters = progressive_counts(cfg, seq)
    n_ba = 2 * len(refined) * tr.pose_ba_iters
    exp_fwd += renders + 40 + n_ba
    exp_bwd += 40 + n_ba
    exp_poses = tracking_renders(cfg, seq) + n_ba
    prog = [h for h in tr.history if h["stage"] == "progressive"]
    exp_bins = renders + n_ba
    it = 0
    for h in prog:
        t = h["frame"]
        if t > 0:                   # tracking: i % rebin_tracking_every
            exp_bins += -(-cfg.tracking_iters // cfg.rebin_tracking_every)
        if t not in train:
            exp_bins += 1           # the test frame's cache render
            continue
        n = cfg.first_frame_mapping_iters if t == 0 else cfg.mapping_iters
        exp_bins += carried_bins([t] * n, it, cfg)
        if t > 0:                   # the keyframe view's own carry
            exp_bins += carried_bins(h["keyframe_views"], it, cfg)
        it += n
    rng = np.random.default_rng(tr.seed + 1)    # global_run's stream
    for _ in range(4):
        exp_bins += carried_bins(
            np.sort(rng.choice(np.asarray(seq.i_train), size=10)).tolist(),
            it, cfg)
        it += 10

    ba_rows = [h for h in tr.history if h["stage"] == "pose_ba"]
    glob = [h for h in tr.history if h["stage"] == "global"]
    losses = ([float(h[k]) for h in prog for k in ("loss", "rgb_loss",
                                                   "flow_loss") if k in h]
              + [h["loss"] for h in glob] + [h["mean_loss"] for h in ba_rows]
              + [c[k] for c in ba_checks for k in ("loss_start",
                                                   "loss_returned")])
    overflow = max([float(h["overflow"]) for h in prog]
                   + [h["overflow"] for h in glob + ba_rows]
                   + [float(o["overflow"]) for o in
                      (out_before, out_reset, out_end)] + [val["overflow"]])
    pinned_equal = all(
        torch.equal(tr.poses.quats[t], poses_global0[0][t])
        and torch.equal(tr.poses.trans[t], poses_global0[1][t])
        for t in pinned)
    monotone = all(c["loss_returned"] <= c["loss_start"] for c in ba_checks)
    summary = dict(
        run_seconds=seconds, progressive_seconds=prog_seconds,
        progressive_iterations=iters,
        progressive_iterations_per_s=iters / prog_seconds,
        global_seconds=global_seconds, global_iterations=40,
        global_iterations_per_s_with_pose_ba=40 / global_seconds,
        launches=launches,
        expected_launches=launch_counts(exp_fwd, exp_bwd, poses=exp_poses),
        binnings=bins, expected_binnings=exp_bins,
        binnings_per_render=bins / exp_fwd,
        keyframe_views={h["frame"]: h["keyframe_views"] for h in prog
                        if "keyframe_views" in h},
        pose_ba_rows=ba_rows, pose_ba_checks=ba_checks,
        pinned_poses_bitwise_equal=pinned_equal,
        psnr_frame0_before=psnr_before,
        psnr_frame0_after_mapping=psnr_cached,
        psnr_frame0_post_reset=psnr_post_reset,
        psnr_frame0_end_of_run=psnr_end,
        validation={k: val[k] for k in VAL_KEYS},
        overflow_max=overflow, max_memory_allocated=peak,
        slice_same_call=slice_summary)
    check(all(math.isfinite(x) for x in losses + [psnr_end]),
          f"non-finite loss or PSNR {losses} {psnr_end}")
    check(launches == launch_counts(exp_fwd, exp_bwd, poses=exp_poses),
          f"launches {launches} != renders made ({exp_fwd}, {exp_bwd})")
    check(bins == exp_bins, f"binnings {bins} != the schedule's {exp_bins}")
    check(psnr_cached > psnr_before,
          f"frame-0 PSNR did not improve: {psnr_before} -> {psnr_cached}")
    check(psnr_end > psnr_post_reset,
          f"the global stage did not fit frame 0 again after the reset: "
          f"{psnr_post_reset} -> {psnr_end}")
    check([h["iter"] for h in ba_rows] == [20, 40],
          f"pose-BA rows {ba_rows}")
    check(monotone, f"a pose-BA pass made a frame worse: {ba_checks}")
    for h in ba_rows:               # the Trainer's row against the renders
        starts = [c["loss_start"] for c in ba_checks if c["iter"] == h["iter"]]
        check(h["mean_loss"] <= h["start_mean_loss"]
              and math.isclose(h["start_mean_loss"], float(np.mean(starts)),
                               rel_tol=1e-5) and h["seconds"] > 0,
              f"pose-BA row {h} against its frames' start losses {starts}")
    check(pinned_equal, f"pose BA moved a pinned frame ({pinned})")
    check(overflow == 0, f"instance overflow {overflow}")
    summary["carry"] = carry_exactness(tr)
    summary["per_iteration"] = iteration_costs(tr)
    phase("reuse", t0, **summary)
    return launches


def run_overlap(dev):
    """progressive_run with keyframe_policy="overlap" (every render bins
    fresh): finite losses, frame 0 fitted, launches = renders."""
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    _, seq = slice_sequence(dev)
    cfg = TrainConfig(**SLICE_CFG, keyframe_policy="overlap")
    tr = Trainer(seq, cfg, log_fn=lambda *a: None, device=dev,
                 validation_every=0, **SLICE_TRAINER)
    rc.reset_launches()
    rc.reset_bins()
    t_run = time.time()
    out_before = tr.render_frame(0)
    tr.progressive_run()
    torch.cuda.synchronize()
    seconds = time.time() - t_run
    launches = dict(rc.LAUNCHES)
    bins = rc.BINS["build_tile_bins"]

    exp_fwd, exp_bwd, iters = progressive_counts(cfg, seq)
    exp_fwd += 1
    prog = [h for h in tr.history if h["stage"] == "progressive"]
    losses = [float(h[k]) for h in prog
              for k in ("loss", "rgb_loss", "flow_loss") if k in h]
    psnr_before = psnr(out_before["render"], seq.colors[0])
    psnr_cached = psnr(tr.state.pred_colors[0].float(), seq.colors[0])
    overflow = max(float(h["overflow"]) for h in prog)
    phase("overlap", t0, progressive_seconds=seconds,
          progressive_iterations_per_s=iters / seconds,
          keyframe_views={h["frame"]: h["keyframe_views"] for h in prog
                          if "keyframe_views" in h},
          psnr_frame0_before=psnr_before,
          psnr_frame0_after_mapping=psnr_cached,
          launches=launches,
          expected_launches=launch_counts(exp_fwd, exp_bwd,
                                          poses=tracking_renders(cfg, seq)),
          binnings=bins, overflow_max=overflow)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(psnr_cached > psnr_before,
          f"frame-0 PSNR did not improve: {psnr_before} -> {psnr_cached}")
    check(launches == launch_counts(exp_fwd, exp_bwd,
                                    poses=tracking_renders(cfg, seq)),
          f"launches {launches} != renders made ({exp_fwd}, {exp_bwd})")
    check(bins == exp_fwd, f"binnings {bins} != renders {exp_fwd}")
    check(overflow == 0, f"instance overflow {overflow}")
    return launches


# The raw phase: scripts/make_fullres_dataset.py --nonrigid's recipe, cut
# to 6 frames (PnP initializes frames 2-5). Its frames move ~50-100 px a
# frame at 1280x1024, where the producer's default 5-level pyramid (coarsest
# 80x64) cannot follow them (median end-point error ~ the motion itself, in
# both packages): the phase produces with 8 levels (coarsest 10x8), the
# depth that keeps the coarsest-level motion near the JAX test's 4 levels
# at 96 px wide, and reports the default's error on the first pair.
RAW_FRAMES = 6
RAW_LEVELS = 8
HS_TOL = 1e-3               # flow, card vs CPU (tests/test_torch_producers)
DISP_RTOL = 1e-5            # disparity, card vs CPU
PNP_TOL = 0.01              # tests/test_pose_utils.py's PnP gate


def raw_scene(dev):
    from freesurgs_tpu_torch.data.synthetic import make_nonrigid_scene
    return make_nonrigid_scene(
        num_frames=RAW_FRAMES, n_gaussians=20000, height=1024, width=1280,
        seed=7, scale_range=(0.004, 0.012), patch_amp=0.02, spec_speed=0.02,
        device=dev)


def textured(color):
    """Pixels with image gradient (the JAX producer test's mask): a
    photometric flow is underdetermined elsewhere."""
    import numpy as np
    gx, gy = np.gradient(color.mean(0))
    return np.hypot(gx, gy) > 0.01


def rank_corr(a, b) -> float:
    """Spearman's rank correlation of two arrays."""
    import numpy as np

    def ranks(x):
        r = np.empty(x.size)
        r[np.argsort(x.ravel(), kind="stable")] = np.arange(x.size)
        return r
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def pose_errors(w2c, gt) -> dict:
    """Translation error (norm), largest rotation-matrix entry error and
    rotation angle (degrees) of a w2c against the ground truth."""
    import torch
    w2c, gt = w2c.double().cpu(), gt.double().cpu()
    dR = w2c[:3, :3].T @ gt[:3, :3]
    cosang = float((torch.trace(dR) - 1.0) / 2.0)
    return {"trans_err": float(torch.linalg.norm(w2c[:3, 3] - gt[:3, 3])),
            "rot_entry_err": float((w2c[:3, :3] - gt[:3, :3]).abs().max()),
            "rot_err_deg": math.degrees(math.acos(max(-1.0,
                                                      min(1.0, cosang))))}


def render_schedule(cfg, seq) -> list[str]:
    """What each forward render of ``progressive_run`` is, in order (as
    ``progressive_counts`` counts them), after one render of frame 0."""
    train = set(int(t) for t in seq.i_train)
    out = ["frame 0 before training"]
    for t in range(int(seq.colors.shape[0])):
        if t > 0:
            out += [f"frame {t} tracking iteration {k}"
                    for k in range(cfg.tracking_iters)]
        if t not in train:
            out.append(f"frame {t} cache render")
        elif t == 0:
            out += [f"frame 0 mapping iteration {k}"
                    for k in range(cfg.first_frame_mapping_iters)]
        else:
            out += [f"frame {t} mapping iteration {k} view {v}"
                    for k in range(cfg.mapping_iters) for v in (0, 1)]
    return out


def raw_training_run(dev, seq, cfg):
    """One Trainer(pose_init="pnp") progressive stage on ``seq``, counters
    reset just before it and read just after. Records, without changing
    the run, each forward render's sum (float64, on the device) and, at
    each PnP init, the constant-velocity init from the same poses."""
    from unittest import mock

    import torch
    from freesurgs_tpu_torch.models import pose as posemod
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.loop import Trainer

    logs = []
    tr = Trainer(seq, cfg, pose_init="pnp", log_fn=logs.append, device=dev,
                 validation_every=0, **SLICE_TRAINER)
    inits, sums, pnp_s = {}, [], []
    real_pnp, real_fwd = posemod.pnp_pose_init, rc.composite_fwd

    def pnp_spy(poses, t, *a, **kw):
        cv = posemod.const_velocity_init(poses, t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new = real_pnp(poses, t, *a, **kw)
        torch.cuda.synchronize()
        pnp_s.append(time.perf_counter() - t1)
        inits[t] = {"pnp": new.w2c(t).detach(),
                    "const_velocity": cv.w2c(t).detach()}
        return new

    def fwd_spy(*a):
        out = real_fwd(*a)
        sums.append(out[0].sum(dtype=torch.float64))
        return out

    with mock.patch.object(posemod, "pnp_pose_init", pnp_spy), \
            mock.patch.object(rc, "composite_fwd", fwd_spy):
        rc.reset_launches()
        t_run = time.time()
        out_before = tr.render_frame(0)
        tr.progressive_run()
        torch.cuda.synchronize()
        seconds = time.time() - t_run
        launches = dict(rc.LAUNCHES)
    psnr_before = psnr(out_before["render"], tr.colors[0])
    return {"trainer": tr, "inits": inits, "sums": torch.stack(sums),
            "pnp_seconds": pnp_s, "seconds": seconds, "launches": launches,
            "psnr_before": psnr_before, "logs": logs}


def run_raw(dev, smi: str) -> dict:
    """From raw frames at 1280x1024: the non-rigid scene written as a
    SCARED directory, its flow/ and monodep/ deleted and produced again by
    ``cli.produce_inputs`` on the card (frames 0-1 also on the CPU, the
    plain path), loaded, and trained by a Trainer(pose_init="pnp")'s
    progressive stage, twice. Returns the launches of the two runs."""
    import shutil

    import numpy as np
    import torch
    from freesurgs_tpu_torch.cli import produce_inputs
    from freesurgs_tpu_torch.data.flow_hs import hs_flow
    from freesurgs_tpu_torch.data.scared import (load_scared,
                                                 save_synthetic_as_scared)
    from freesurgs_tpu_torch.models import pose as posemod
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    steps, res = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root, root01 = Path(tmp) / "raw", Path(tmp) / "raw01"
        t1 = time.time()
        scene, aux = raw_scene(dev)
        torch.cuda.synchronize()
        steps["scene"] = time.time() - t1
        t1 = time.time()
        save_synthetic_as_scared(scene, str(root))
        for sub in ("flow", "monodep"):
            shutil.rmtree(root / sub)
        steps["write_frames"] = time.time() - t1

        # 1. the inputs, produced on the card
        t1 = time.time()
        prod = produce_inputs.produce(str(root), levels=RAW_LEVELS,
                                      device=dev, log=lambda s: None)
        steps["produce_card"] = time.time() - t1
        check(prod["flow_pairs"] == RAW_FRAMES - 1
              and prod["depth_maps"] == RAW_FRAMES, f"produced {prod}")
        pngs = sorted((root / "input").glob("*.png"))
        stems = [p.name.split(".")[0] for p in pngs]

        def npz(path):
            with np.load(path) as z:
                return z["pred"]

        fws = [npz(root / "flow" / f"flow_fw_{s}.npz") for s in stems[:-1]]
        colors = scene.colors.cpu().numpy()
        epe, gate = [], []
        for t, fw in enumerate(fws):
            gt = scene.flows_fw[t].cpu().numpy()
            tex = textured(colors[t])
            e = np.hypot(*(fw - gt))[tex]
            gt_med = float(np.median(np.hypot(*gt)[tex]))
            epe.append({"pair": t, "median_epe_px": float(np.median(e)),
                        "median_gt_px": gt_med,
                        "gate_px": max(0.5, 0.5 * gt_med),
                        "textured_share": float(tex.mean())})
            gate.append(epe[-1]["median_epe_px"] < epe[-1]["gate_px"])
        # the producer's default pyramid on the first pair, reported
        frames = produce_inputs.load_frames(str(root))[0]
        f5 = hs_flow(torch.from_numpy(frames[0]).to(dev),
                     torch.from_numpy(frames[1]).to(dev)).cpu().numpy()
        gt0 = scene.flows_fw[0].cpu().numpy()
        epe_default = float(np.median(np.hypot(*(f5 - gt0))[
            textured(colors[0])]))
        disp_rho = [rank_corr(npz(root / "monodep" / f"depth_{s}.npz"),
                              1.0 / scene.depths[t].cpu().numpy())
                    for t, s in enumerate(stems)]
        res.update(flow_seconds_per_field=[x / 2 for x in
                                           prod["flow_seconds"]],
                   flow_levels=RAW_LEVELS, hs_epe=epe,
                   hs_epe_pair0_default_levels_5=epe_default,
                   disparity_rank_corr_with_inverse_depth=disp_rho)
        check(all(gate), f"Horn-Schunck end-point error over the gate: {epe}")

        # 2. frames 0-1 on the CPU (the plain path): the same arrays
        (root01 / "input").mkdir(parents=True)
        for p in pngs[:2]:
            shutil.copy(p, root01 / "input" / p.name)
        t1 = time.time()
        produce_inputs.produce(str(root01), levels=RAW_LEVELS, device="cpu",
                               log=lambda s: None)
        steps["produce_cpu_frames_0_1"] = time.time() - t1
        diff = {}
        for kind in ("flow_fw", "flow_bw"):
            a = npz(root / "flow" / f"{kind}_{stems[0]}.npz")
            b = npz(root01 / "flow" / f"{kind}_{stems[0]}.npz")
            diff[kind] = float(np.abs(a - b).max())
        a = npz(root / "monodep" / f"depth_{stems[0]}.npz")
        b = npz(root01 / "monodep" / f"depth_{stems[0]}.npz")
        diff["disparity_rel"] = float(np.max(np.abs(a - b) / np.abs(b)))
        res["card_vs_cpu_frames_0_1"] = diff
        check(diff["flow_fw"] <= HS_TOL and diff["flow_bw"] <= HS_TOL
              and diff["disparity_rel"] <= DISP_RTOL,
              f"the card's inputs differ from the CPU's: {diff}")

        # 3. PnP on the analytic flow and the rendered depth (frame 2)
        gtp = posemod.PoseTable(quats=scene.gt_quats.clone(),
                                trans=scene.gt_trans.clone())
        start = posemod.copy_previous_init(gtp, 2)
        pnp2 = posemod.pnp_pose_init(start, 2, scene.flows_fw[1],
                                     scene.depths[1], scene.gt_w2c[1],
                                     scene.cam, seed=2)
        err2 = pose_errors(pnp2.w2c(2), scene.gt_w2c[2])
        res["pnp_analytic_frame2"] = err2
        check(err2["trans_err"] < PNP_TOL and err2["rot_entry_err"] < PNP_TOL,
              f"PnP on the analytic flow missed frame 2: {err2}")

        # 4. the training job from the produced inputs, twice
        t1 = time.time()
        seq = load_scared(str(root), cache=None)
        steps["load"] = time.time() - t1
    cfg = TrainConfig(**SLICE_CFG)
    runs = [raw_training_run(dev, seq, cfg) for _ in range(2)]
    tr = runs[0]["trainer"]
    exp_fwd, exp_bwd, iters = progressive_counts(cfg, seq)
    exp = launch_counts(exp_fwd + 1, exp_bwd,
                        poses=tracking_renders(cfg, seq))
    prog = [h for h in tr.history if h["stage"] == "progressive"]
    losses = [float(h[k]) for h in prog
              for k in ("loss", "rgb_loss", "flow_loss") if k in h]
    psnr_cached = psnr(tr.state.pred_colors[0].float(), tr.colors[0])
    inits = {t: {k: pose_errors(w, scene.gt_w2c[t]) for k, w in v.items()}
             for t, v in runs[0]["inits"].items()}
    # the two runs: the first forward render whose sum differs, and the
    # final state
    a, b = runs[0]["sums"], runs[1]["sums"]
    differ = (a != b).nonzero()
    schedule = render_schedule(cfg, seq)
    first = (None if a.shape != b.shape or len(differ) == 0
             else schedule[int(differ[0])])
    t2 = runs[1]["trainer"]
    same_state = (torch.equal(tr.poses.quats, t2.poses.quats)
                  and torch.equal(tr.poses.trans, t2.poses.trans)
                  and all(torch.equal(getattr(tr.field, k),
                                      getattr(t2.field, k))
                          for k in ("means", "quats", "log_scales",
                                    "logit_opacity", "sh_dc", "sh_rest",
                                    "active")))
    # the rigidity mask of each frame pair (t-2 -> t-1) on the run's poses
    # against the scene's non-rigid pixels at t-2
    mask_scores = []
    for t in range(2, RAW_FRAMES):
        pred = (tr._rigid_mask(t) == 0).cpu().numpy()
        gt = aux["nonrigid_mask"][t - 2].cpu().numpy()
        hit = float((pred & gt).sum())
        mask_scores.append({"pair": [t - 2, t - 1],
                            "precision": hit / max(float(pred.sum()), 1.0),
                            "recall": hit / max(float(gt.sum()), 1.0),
                            "excluded_share": float(pred.mean()),
                            "nonrigid_share": float(gt.mean())})
    phase("raw", t0, nvidia_smi=smi, step_seconds=steps, **res,
          progressive_seconds=[r["seconds"] for r in runs],
          progressive_iterations_per_s=[iters / r["seconds"] for r in runs],
          pnp_init_seconds=runs[0]["pnp_seconds"], pnp_vs_const_velocity={
              str(t): v for t, v in sorted(inits.items())},
          psnr_frame0_before=runs[0]["psnr_before"],
          psnr_frame0_after_mapping=psnr_cached,
          rigidity_mask=mask_scores,
          run_to_run={"renders_compared": int(a.numel()),
                      "first_differing_render": first,
                      "final_state_bitwise_equal": same_state},
          launches=[r["launches"] for r in runs], expected_launches=exp,
          test_frames=[int(t) for t in seq.i_test],
          log=runs[0]["logs"])
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(psnr_cached > runs[0]["psnr_before"],
          f"frame-0 PSNR did not improve: {runs[0]['psnr_before']} -> "
          f"{psnr_cached}")
    check(sorted(inits) == list(range(2, RAW_FRAMES)),
          f"PnP initialized frames {sorted(inits)}")
    for r in runs:
        check(r["launches"] == exp,
              f"launches {r['launches']} != renders made {exp}")
    return {"raw": runs[0]["launches"], "raw_repeat": runs[1]["launches"]}


# The cli phase's depth cut, through --train_override: the slice's, with
# the global stage's 40 iterations as global_iters.
CLI_OVERRIDES = {**SLICE_CFG, "global_iters": 40}


def cli_argv(data: Path, out: Path) -> list[str]:
    argv = ["--data_source_path", str(data), "--run_model_path", str(out),
            "--run_global_chunk", "10", "--model_init_mask_frac", "0.1",
            "--data_sample_rate", "4"]
    for k, v in CLI_OVERRIDES.items():
        argv += ["--train_override", f"{k}={v}"]
    return argv


def quiet(fn, *args):
    """(fn(*args), what it printed): the CLIs' console lines stay out of
    this script's JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue()


def metric_rows(out: Path) -> list[dict]:
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


def check_png_codec(frames: list, pngs: list[Path]) -> dict:
    """The fixture's PNGs decode to the uint8 frames written; frame 0's
    stream un-filters bitwise by the native and the plain version (host
    clock rates over the image bytes), and frame 0 encoded with each filter
    type forced on every row decodes back bitwise."""
    import numpy as np
    from freesurgs_tpu_torch.io import native, png

    H, W = frames[0].shape[:2]
    nbytes = H * W * 3
    t = time.perf_counter()
    native.build()                      # g++, unless this source's exists
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    decoded = [png.read_png(str(p)) for p in pngs]
    read_s = time.perf_counter() - t
    check(all(np.array_equal(d, f) for d, f in zip(decoded, frames)),
          "a fixture frame does not decode to the array written")
    counts = np.zeros(5, np.int64)
    for p in pngs:
        _, raw = png.read_chunks(str(p))
        counts += np.bincount(np.frombuffer(raw, np.uint8)
                              .reshape(H, 1 + 3 * W)[:, 0], minlength=5)
    _, raw0 = png.read_chunks(str(pngs[0]))
    raw0 = np.frombuffer(raw0, np.uint8)
    t = time.perf_counter()
    for _ in range(10):
        nat = native.png_unfilter(raw0, H, W, 3)
    native_s = (time.perf_counter() - t) / 10
    t = time.perf_counter()
    plain = png.unfilter_plain(raw0, H, W)
    plain_s = time.perf_counter() - t
    check(np.array_equal(nat, plain), "native and plain un-filter differ")
    cands = png.filter_candidates(frames[0])
    forced = []
    for k in range(5):
        stream = np.concatenate([np.full((H, 1), k, np.uint8), cands[k]], 1)
        forced.append(np.array_equal(
            native.png_unfilter(stream.ravel(), H, W, 3),
            frames[0].reshape(H, 3 * W)))
    check(all(forced), f"a forced filter type does not decode: {forced}")
    return {"fsio_build_seconds": build_s,
            "frames_decoded_bitwise": True, "rows_by_filter_type":
            counts.tolist(), "forced_filter_types_bitwise": forced,
            "frame0_native_equals_plain": True,
            "unfilter_native_ms": native_s * 1e3,
            "unfilter_plain_ms": plain_s * 1e3,
            "unfilter_native_mb_per_s": nbytes / native_s / 1e6,
            "unfilter_plain_mb_per_s": nbytes / plain_s / 1e6,
            "native_over_plain": plain_s / native_s,
            "read_png_mb_per_s": 4 * nbytes / read_s / 1e6}


def run_cli(dev, smi: str, slice_summary: dict) -> dict:
    """The port's command line end to end at 1280x1024: the slice's scene
    written as a SCARED directory, loaded raw and from the FSC1 cache the
    first load wrote, ``cli.train`` (progressive, global, checkpoints, PLY,
    validation, panels), ``cli.train --run_test`` from the latest
    checkpoint, and ``cli.render --split all``. Launch counters reset just
    before each of the three commands and read just after; returns their
    sum."""
    from unittest import mock

    import numpy as np
    import torch
    from freesurgs_tpu_torch.cli import render as cli_render
    from freesurgs_tpu_torch.cli import train as cli_train
    from freesurgs_tpu_torch.data.scared import (cache_path, frame_uint8,
                                                 load_scared,
                                                 save_synthetic_as_scared)
    from freesurgs_tpu_torch.io.checkpoint import restore_checkpoint
    from freesurgs_tpu_torch.io.png import read_png
    from freesurgs_tpu_torch.io.ply import ply_to_field
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    steps, res = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data, out = Path(tmp) / "data", Path(tmp) / "run"
        argv = cli_argv(data, out)

        # 1. the fixture, written by the port
        t1 = time.time()
        scene, _ = slice_sequence(dev)
        frames = [frame_uint8(c) for c in scene.colors]
        save_synthetic_as_scared(scene, str(data))
        del scene
        steps["write_fixture"] = time.time() - t1
        n_frames = len(frames)
        H, W = frames[0].shape[:2]
        pngs = sorted((data / "input").glob("*.png"))
        check(len(pngs) == n_frames, f"{len(pngs)} frames written")
        res["png"] = check_png_codec(frames, pngs)

        # 2. loaded raw (writing the cache), then from the cache
        t1 = time.time()
        raw = load_scared(str(data), sample_rate=4)
        steps["load_raw_and_write_cache"] = time.time() - t1
        cpath = Path(cache_path(str(data), 0, -1, 4, "normalized"))
        check(cpath.exists(), "the first load wrote no FSC1 cache")
        t1 = time.time()
        cached = load_scared(str(data), sample_rate=4)
        steps["load_cached"] = time.time() - t1
        same = {k: bool(np.array_equal(getattr(raw, k), getattr(cached, k)))
                for k in ("colors", "flows_fw", "flows_bw", "monodeps",
                          "i_train", "i_test")}
        same["boundaries_and_names"] = (
            raw.boundaries == cached.boundaries
            and raw.image_names == cached.image_names)
        same["K_and_poses_to_f32"] = (
            np.array_equal(raw.cam.intrinsic_matrix(),
                           cached.cam.intrinsic_matrix())
            and list(raw.gt_poses) == list(cached.gt_poses)
            and all(np.array_equal(raw.gt_poses[k].astype(np.float32),
                                   cached.gt_poses[k])
                    for k in raw.gt_poses))
        check(all(same.values()), f"the cached load differs: {same}")
        check(list(cached.i_test) == [2], f"test frames {cached.i_test}")
        res["cache_equal_to_raw"] = same
        res["cache_bytes"] = cpath.stat().st_size

        # 3. cli.train, the stages timed by wrapping the Trainer's methods
        stage = {}

        def timed(name, fn):
            def run(self, *a, **kw):
                t = time.time()
                r = fn(self, *a, **kw)
                torch.cuda.synchronize()
                stage[name] = time.time() - t
                return r
            return run

        rc.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        with mock.patch.object(Trainer, "progressive_run", timed(
                "progressive", Trainer.progressive_run)), \
                mock.patch.object(Trainer, "global_run", timed(
                    "global", Trainer.global_run)):
            code, log = quiet(cli_train.main, argv)
        torch.cuda.synchronize()
        steps["train"] = time.time() - t1
        launches = {"train": dict(rc.LAUNCHES)}
        res["peak_memory_allocated_train"] = torch.cuda.max_memory_allocated()
        check(code == 0 and "all complete" in log,
              f"cli.train exited {code}: {log[-2000:]}")
        for name in ("config.json", "metrics.jsonl", "ckpt_progressive",
                     "ckpt_final", "point_cloud.ply"):
            check((out / name).exists(), f"cli.train wrote no {name}")
        rows = metric_rows(out)
        final = {k: rows[-1].get(k) for k in VAL_KEYS}
        check(all(isinstance(v, float) and math.isfinite(v)
                  for v in final.values()), f"final validation {rows[-1]}")
        # the renders: progressive (tracking, mapping, the test frame's
        # cache render), 40 global iterations, the final validation, and
        # a panel render per compare panel and per val panel
        cfg = TrainConfig(**CLI_OVERRIDES)
        exp_fwd, exp_bwd, iters = progressive_counts(cfg, cached)
        n_test = len(cached.i_test)
        compare = [t for t in cached.i_train if t % 25 == 0]
        exp = launch_counts(exp_fwd + cfg.global_iters + n_test
                            + len(compare) + n_test,
                            exp_bwd + cfg.global_iters,
                            poses=tracking_renders(cfg, cached))
        check(launches["train"] == exp,
              f"cli.train launches {launches['train']} != renders {exp}")
        panels = sorted(p.name for p in (out / "panels").glob("*.png"))
        want = ([f"compare_f{t:04d}" for t in compare]
                + [f"val_f{t:04d}" for t in cached.i_test])
        check(sorted(p.rsplit("_", 1)[0] for p in panels) == sorted(want),
              f"panels {panels}, expected {want}")
        for p in panels:
            t = int(p.split("_f")[1][:4])
            parts = 5 if t + 1 < n_frames else 4
            shape = read_png(str(out / "panels" / p)).shape
            check(shape == (H + 9, parts * W + 2 * (parts - 1), 3),
                  f"panel {p} has shape {shape}")
        tree, _ = restore_checkpoint(str(out / "ckpt_final"),
                                     map_location="cpu")
        fld = tree["state"]["field"]
        act = fld["active"]
        ply = ply_to_field(str(out / "point_cloud.ply"),
                           max_sh_degree=int(fld["max_sh_degree"]),
                           device="cpu")
        ply_equal = ply.capacity == int(act.sum()) and all(
            torch.equal(getattr(ply, k), fld[k][act]) for k in (
                "means", "quats", "log_scales", "logit_opacity", "sh_dc",
                "sh_rest"))
        check(ply_equal, "point_cloud.ply differs from the final field")
        res.update(ply_rows=ply.capacity, num_active=int(act.sum()),
                   ply_bytes=(out / "point_cloud.ply").stat().st_size,
                   ply_equal_to_final_field_bitwise=ply_equal,
                   panels=panels, final_validation=final,
                   progressive_seconds=stage["progressive"],
                   progressive_iterations=iters,
                   progressive_iterations_per_s=iters / stage["progressive"],
                   global_seconds=stage["global"],
                   global_iterations_per_s=cfg.global_iters / stage["global"],
                   slice_same_call={k: slice_summary[k] for k in (
                       "progressive_iterations_per_s",
                       "global_iterations_per_s_with_val_and_ckpt",
                       "resumed_global_iterations_per_s")})

        # 4. validation alone from the latest checkpoint
        rc.reset_launches()
        t1 = time.time()
        code, log = quiet(cli_train.main, argv + [
            "--run_start_checkpoint", "latest", "--run_test", "true"])
        torch.cuda.synchronize()
        steps["resume_validate"] = time.time() - t1
        launches["resume_validate"] = dict(rc.LAUNCHES)
        rows2 = metric_rows(out)
        resumed = {k: rows2[-1].get(k) for k in VAL_KEYS}
        check(code == 0 and "ckpt_final" in log and len(rows2) == len(rows)
              + 1, f"cli.train --run_test exited {code}: {log[-2000:]}")
        check(resumed == final, f"resumed validation {resumed} != the "
              f"final one {final}")
        check(launches["resume_validate"] == launch_counts(2 * n_test, 0),
            f"resume launches {launches['resume_validate']}")

        # 5. cli.render over every frame
        rc.reset_launches()
        t1 = time.time()
        code, log = quiet(cli_render.main, argv + [
            "--run_start_checkpoint", str(out / "ckpt_final"),
            "--split", "all"])
        torch.cuda.synchronize()
        steps["render"] = time.time() - t1
        launches["render"] = dict(rc.LAUNCHES)
        check(code == 0, f"cli.render exited {code}: {log[-2000:]}")
        renders = sorted((out / "renders").glob("all_*.png"))
        check(len(renders) == n_frames and all(
            read_png(str(p)).shape == (H + 9, 4 * W + 6, 3)
            for p in renders), f"renders {renders}")
        cams = json.loads((out / "cameras.json").read_text())
        check(len(cams) == n_frames, f"{len(cams)} cameras.json records")
        printed = ast.literal_eval([ln for ln in log.splitlines()
                                    if ln.startswith("{'psnr'")][-1])
        check(all(math.isfinite(printed[k]) for k in ("psnr", "ssim",
                                                      "lpips")),
              f"render metrics {printed}")
        check(launches["render"] == launch_counts(n_frames, 0),
              f"render launches {launches['render']}")
        res["render_metrics"] = printed
    total = {k: sum(v[k] for v in launches.values())
             for k in launch_counts(0, 0)}
    phase("cli", t0, nvidia_smi=smi, step_seconds=steps, launches=launches,
          **res)
    return total


# The fullres phase: cli.make_fullres_dataset's recipe at full width
# (1280x1024, 20,000 Gaussians, seed 7) cut to FULLRES_FRAMES frames, then
# cli.run_config34 at cfg34_r5c's settings with its global stage cut to
# 100 iterations in chunks of 50 (a checkpoint after each), the final pose
# BA, and a resume from the 50-iteration checkpoint. Depth stays the
# reference's (TrainConfig defaults: 200 / 50 / 30 iterations).
FULLRES_FRAMES = 10
FULLRES_GLOBAL = 100
FULLRES_CHUNK = 50
BA_KEYS = ("pose_ba_final_passes", "pose_ba_polish", "pose_ba_s")
RESUME_KEYS = ("resumed_from", "resumed_at_global_iter")


def jax_summary_keys() -> set[str]:
    """The JAX scripts/run_config34.py's summary keys, read from its
    full-scale record (results/cfg34_r5c_summary.json)."""
    return set(json.loads(
        (REPO / "results" / "cfg34_r5c_summary.json").read_text()))


def fullres_argv(dev, data: Path, out: Path, *extra: str) -> list[str]:
    return ["--data", str(data), "--out", str(out),
            "--frames", str(FULLRES_FRAMES), "--depth_prior", "metric",
            "--rebin_every", "4", "--global_iters", str(FULLRES_GLOBAL),
            "--global_chunk", str(FULLRES_CHUNK), "--checkpoint_every",
            str(FULLRES_CHUNK), "--device", dev.type, *extra]


def finite_metrics(summary: dict, prefix: str = "") -> bool:
    return all(isinstance(summary.get(prefix + k), float)
               and math.isfinite(summary[prefix + k])
               for k in ("psnr", "ssim", "ate"))


def ply_equals_field(ply_path: Path, ckpt: Path) -> bool:
    """The PLY's rows are the checkpoint field's active rows, bitwise."""
    import torch
    from freesurgs_tpu_torch.io.checkpoint import restore_checkpoint
    from freesurgs_tpu_torch.io.ply import ply_to_field
    tree, _ = restore_checkpoint(str(ckpt), map_location="cpu")
    fld = tree["state"]["field"]
    act = fld["active"]
    ply = ply_to_field(str(ply_path), max_sh_degree=int(fld["max_sh_degree"]),
                       device="cpu")
    return ply.capacity == int(act.sum()) and all(
        torch.equal(getattr(ply, k), fld[k][act]) for k in (
            "means", "quats", "log_scales", "logit_opacity", "sh_dc",
            "sh_rest"))


def run_fullres(dev, smi: str, tmp: Path) -> dict:
    """The full-scale recipe and run_config34 at full width, depth cut: the
    dataset written by ``cli.make_fullres_dataset``, ``cli.run_config34``
    (progressive, 100 global iterations in two chunks with a checkpoint
    after each, ckpt_final / PLY / cameras.json, validation, the final pose
    BA and its summary), then ``--resume`` from the 50-iteration
    checkpoint. Counters reset just before each command and read just
    after; returns their launches."""
    import torch
    from freesurgs_tpu_torch.cli import make_fullres_dataset, run_config34
    from freesurgs_tpu_torch.data.scared import load_scared
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    data, out, out2 = tmp / "fullres", tmp / "cfg34", tmp / "cfg34_resume"
    steps, res = {}, {}
    t1 = time.time()
    gen, log = quiet(make_fullres_dataset.main, [
        "--out", str(data), "--frames", str(FULLRES_FRAMES), "--device",
        dev.type])
    steps["make_fullres_dataset"] = time.time() - t1
    check(gen["overflow_total"] == 0, f"dataset overflow: {log}")
    res["dataset"] = gen

    rc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    code, log = quiet(run_config34.main, fullres_argv(
        dev, data, out, "--save_ckpt", "--pose_ba_final", "1"))
    torch.cuda.synchronize()
    steps["run_config34"] = time.time() - t1
    launches = {"fullres": dict(rc.LAUNCHES)}
    res["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    check(code == 0, f"run_config34 exited {code}: {log[-2000:]}")
    summary = json.loads((out / "summary.json").read_text())
    summary_ba = json.loads((out / "summary_ba.json").read_text())
    keys = jax_summary_keys()
    val_keys = keys & {"psnr", "ssim", "lpips", "lpips_backend",
                       "psnr_train", "ate", "rpe_trans", "rpe_rot_deg"}
    check(set(summary) == keys, f"summary keys {sorted(summary)} != the "
          f"JAX script's {sorted(keys)}")
    check(set(summary_ba) == keys | set(BA_KEYS)
          | {"ba_" + k for k in val_keys},
          f"summary_ba keys {sorted(summary_ba)}")
    check(summary["global_iters_done"] == FULLRES_GLOBAL,
          f"global iterations {summary['global_iters_done']}")
    check(finite_metrics(summary) and finite_metrics(summary_ba, "ba_"),
          f"validation {summary}, after BA {summary_ba}")
    for name in ("ckpt_0000050", "ckpt_0000100", "ckpt_final",
                 "point_cloud.ply", "cameras.json"):
        check((out / name).exists(), f"run_config34 wrote no {name}")
    ply_equal = ply_equals_field(out / "point_cloud.ply", out / "ckpt_final")
    check(ply_equal, "point_cloud.ply differs from the final field")

    # the renders: progressive, the global iterations, the validation
    # (test views and every 8th train view), the BA pass over the train
    # frames but 0 and its validation
    seq = load_scared(str(data), 0, FULLRES_FRAMES, sample_rate=8,
                      depth_prior="metric")
    cfg = TrainConfig()
    exp_fwd, exp_bwd, iters = progressive_counts(cfg, seq)
    train = [int(t) for t in seq.i_train]
    n_val = len(seq.i_test) + len(train[::8])
    n_ba = 25 * len([t for t in train if t != 0])
    exp = launch_counts(exp_fwd + FULLRES_GLOBAL + 2 * n_val + n_ba,
                        exp_bwd + FULLRES_GLOBAL + n_ba,
                        poses=tracking_renders(cfg, seq) + n_ba)
    check(launches["fullres"] == exp,
          f"run_config34 launches {launches['fullres']} != renders {exp}")

    # resume from the 50-iteration checkpoint
    rc.reset_launches()
    t1 = time.time()
    code, log = quiet(run_config34.main, fullres_argv(
        dev, data, out2, "--resume", str(out / "ckpt_0000050")))
    torch.cuda.synchronize()
    steps["run_config34_resume"] = time.time() - t1
    launches["fullres_resume"] = dict(rc.LAUNCHES)
    check(code == 0, f"run_config34 --resume exited {code}: {log[-2000:]}")
    resumed = json.loads((out2 / "summary.json").read_text())
    check(set(resumed) == keys | set(RESUME_KEYS),
          f"resumed summary keys {sorted(resumed)}")
    check(resumed["resumed_at_global_iter"] == FULLRES_CHUNK
          and resumed["global_iters_done"] == FULLRES_GLOBAL,
          f"resume from {resumed['resumed_at_global_iter']} to "
          f"{resumed['global_iters_done']}")
    check(finite_metrics(resumed), f"resumed validation {resumed}")
    rest = FULLRES_GLOBAL - FULLRES_CHUNK
    exp_resume = launch_counts(rest + n_val, rest)
    check(launches["fullres_resume"] == exp_resume,
          f"resume launches {launches['fullres_resume']} != {exp_resume}")
    stage = {k: summary[k] for k in ("progressive_s", "global_s",
                                     "validation_s", "total_s")}
    stage["pose_ba_s"] = summary_ba["pose_ba_s"]
    phase("fullres", t0, nvidia_smi=smi, step_seconds=steps,
          stage_seconds=stage, progressive_iterations=iters,
          progressive_iterations_per_s=iters / summary["progressive_s"],
          global_iterations_per_s=FULLRES_GLOBAL / summary["global_s"],
          launches=launches, summary=summary, summary_ba={
              k: v for k, v in summary_ba.items() if k.startswith("ba_")
              or k in BA_KEYS}, resumed={k: resumed[k] for k in (
                  "resumed_at_global_iter", "global_iters_done", "psnr",
                  "ssim", "ate", "global_s")},
          ply_equal_to_final_field_bitwise=ply_equal, **res)
    return launches


# The tpu_rows phase: the recipe's first TPU_ROWS_FRAMES frames (fullres's
# dataset: the trajectory and the field are drawn frame by frame, so its
# first frames are the 60-frame recipe's) through cli.run_config34 at
# cfg34_r5c's settings with no global stage, beside cfg34_r5c's rows
# (results/cfg34_r5c_metrics.jsonl, the JAX package on a TPU v5e) and the
# recorded Arm A (results/torch_cfg34_h100_metrics.jsonl). The flow loss
# back-projects the bf16 depth cache in bf16, as the JAX package does; an
# f32 back-projection did not bring the port to the TPU's rows either
# (PERF.md §6), so the rows are gated finite only.
TPU_ROWS_FRAMES = 6
TPU_ROWS_KEYS = ("flow_loss", "rgb_loss", "gn_resid_px")


def progressive_rows(path: Path, frames: int) -> dict[int, dict]:
    """The progressive stage's rows of frames 1 .. frames - 1 of a
    metrics.jsonl, by frame."""
    rows = {}
    for ln in path.read_text().splitlines():
        r = json.loads(ln)
        t = int(r.get("frame", -1))
        if r.get("stage") == "progressive" and 0 < t < frames:
            rows[t] = {k: r[k] for k in TPU_ROWS_KEYS}
    return rows


def witness_frame1() -> dict:
    """Frame 1's tracking rows of ``tests/fullwidth_witness.py`` (its
    committed ``results/fullwidth_witness.json``): the JAX package and the
    port on the CPU at 1280x1024, ``tracking_loop`` from one shared state
    after a cut frame-0 mapping (the cuts listed)."""
    res = json.loads((REPO / "results" / "fullwidth_witness.json"
                      ).read_text())
    rows = res["steps"]["5_tracking_frame1"]["tracking"]["rows"]
    return {"cuts": res["cuts"],
            **{k: {"jax_cpu": rows[k][0], "port_cpu": rows[k][1]}
               for k in TPU_ROWS_KEYS}}


def run_tpu_rows(dev, smi: str, tmp: Path) -> dict:
    """The port's first frames against the TPU's rows: ``cli.run_config34
    --frames 6 --global_iters 0`` at cfg34_r5c's settings on fullres's
    dataset, its per-frame flow_loss / rgb_loss / gn_resid_px printed
    beside cfg34_r5c's and Arm A's. Counters reset just before the command
    and read just after (launches = renders). Returns the launches."""
    import torch
    from freesurgs_tpu_torch.cli import run_config34
    from freesurgs_tpu_torch.data.scared import load_scared
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.steps import TrainConfig

    t0 = time.time()
    data, out = tmp / "fullres", tmp / "tpu_rows"
    rc.reset_launches()
    code, log = quiet(run_config34.main, [
        "--data", str(data), "--out", str(out), "--frames",
        str(TPU_ROWS_FRAMES), "--depth_prior", "metric", "--rebin_every",
        "4", "--tracking_gn_iters", "8", "--global_iters", "0",
        "--device", dev.type])
    torch.cuda.synchronize()
    launches = {"tpu_rows": dict(rc.LAUNCHES)}
    check(code == 0, f"run_config34 exited {code}: {log[-2000:]}")
    seq = load_scared(str(data), 0, TPU_ROWS_FRAMES, sample_rate=8,
                      depth_prior="metric")
    fwd, bwd, _ = progressive_counts(TrainConfig(), seq)
    n_val = len(seq.i_test) + len([int(t) for t in seq.i_train][::8])
    want = launch_counts(fwd + n_val, bwd,
                         poses=tracking_renders(TrainConfig(), seq))
    check(launches["tpu_rows"] == want,
          f"tpu_rows launches {launches['tpu_rows']} != renders {want}")

    port = progressive_rows(out / "metrics.jsonl", TPU_ROWS_FRAMES)
    tpu = progressive_rows(REPO / "results" / "cfg34_r5c_metrics.jsonl",
                           TPU_ROWS_FRAMES)
    arm_a = progressive_rows(
        REPO / "results" / "torch_cfg34_h100_metrics.jsonl", TPU_ROWS_FRAMES)
    frames = range(1, TPU_ROWS_FRAMES)
    rows = [{"frame": t, **{k: {"port": port[t][k], "tpu": tpu[t][k],
                                "arm_a": arm_a[t][k],
                                "port_over_tpu": port[t][k] / tpu[t][k]}
                            for k in TPU_ROWS_KEYS}} for t in frames
            if t in port]
    phase("tpu_rows", t0, nvidia_smi=smi, launches=launches, rows=rows,
          equal_to_arm_a=all(port.get(t) == arm_a[t] for t in frames),
          fullwidth_witness_frame1=witness_frame1())
    check(sorted(port) == list(frames)
          and all(math.isfinite(v) for r in port.values() for v in r.values()),
          f"rows {port}")
    return launches


class StubElem:
    """A GUI element of the stub viser server (tests/test_viewer_panels.py's
    shape): a value and the callbacks registered on it."""

    def __init__(self, value=None):
        self.value = value
        self._cbs = []

    def on_click(self, fn):
        self._cbs.append(fn)
        return fn

    on_update = on_click

    def click(self, event=None):
        for fn in self._cbs:
            fn(event)


class StubGui:
    def __init__(self):
        self.elems = {}

    @contextlib.contextmanager
    def add_folder(self, name):
        yield

    def add_button(self, label):
        self.elems[label] = StubElem()
        return self.elems[label]

    def add_slider(self, label, min, max, step, initial_value):
        self.elems[label] = StubElem(initial_value)
        return self.elems[label]

    def add_text(self, label, initial_value=""):
        self.elems[label] = StubElem(initial_value)
        return self.elems[label]


class StubScene:
    def __init__(self):
        self.backgrounds = []

    def add_camera_frustum(self, *a, **k):
        pass

    def set_background_image(self, img):
        self.backgrounds.append(img)


class StubCamera:
    def __init__(self):
        self.wxyz = [1.0, 0.0, 0.0, 0.0]
        self.position = [0.0, 0.0, 0.0]

    def on_update(self, fn):
        return fn


class StubClient:
    def __init__(self):
        self.scene = StubScene()
        self.camera = StubCamera()


class StubServer:
    def __init__(self):
        self.gui = StubGui()
        self.scene = StubScene()
        self._connect = []

    def on_client_connect(self, fn):
        self._connect.append(fn)
        return fn

    def connect(self):
        client = StubClient()
        for fn in self._connect:
            fn(client)
        return client


class ReportSpy:
    """A Trainer viewer that records each report."""

    def __init__(self):
        self.reports = []

    def report(self, rays_per_sec=None, frame=None):
        self.reports.append((rays_per_sec, frame))

    def wait_if_paused(self):
        pass


def run_viz(dev, smi: str, tmp: Path) -> dict:
    """The viewer's render paths on fullres's trained field at 1280x1024:
    ``render_path`` over an interpolated and an orbit path, ``GSViewer`` on
    a stub server (a client view, a playback tick, a path export), and a
    Trainer with a viewer for one global chunk. Counters reset just before
    each and read just after; returns their launches."""
    import numpy as np
    import torch
    from freesurgs_tpu_torch.data.scared import load_scared
    from freesurgs_tpu_torch.io.checkpoint import restore_checkpoint
    from freesurgs_tpu_torch.io.png import read_png
    from freesurgs_tpu_torch.models.gaussians import GaussianField
    from freesurgs_tpu_torch.models.pose import PoseTable
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig
    from freesurgs_tpu_torch.viz.camera_path import (ellipse_orbit,
                                                     interpolate_path,
                                                     render_path,
                                                     render_view)
    from freesurgs_tpu_torch.viz.viewer import GSViewer

    t0 = time.time()
    steps, res = {}, {}
    data, ckpt = tmp / "fullres", tmp / "cfg34" / "ckpt_final"
    seq = load_scared(str(data), 0, FULLRES_FRAMES, sample_rate=8,
                      depth_prior="metric")
    cam = seq.cam
    tree, _ = restore_checkpoint(str(ckpt), map_location=dev)
    fld = dict(tree["state"]["field"])
    field = GaussianField(**fld)
    poses = PoseTable(**tree["poses"])
    with torch.no_grad():
        w2c_all = poses.all_w2c()
    train = [int(t) for t in seq.i_train]
    keyposes = w2c_all[train].cpu().numpy()
    fps = 4
    paths = {"interpolate": interpolate_path(keyposes, fps),
             "ellipse": ellipse_orbit(keyposes, 8)}

    # 1. render_path over both paths
    launches, frames = {}, {}
    for name, path in paths.items():
        rc.reset_launches()
        t1 = time.time()
        frames[name] = render_path(field, path, cam, str(tmp / name))
        torch.cuda.synchronize()
        steps[f"render_path_{name}"] = time.time() - t1
        launches[f"render_path_{name}"] = dict(rc.LAUNCHES)
        check(launches[f"render_path_{name}"] == launch_counts(len(path), 0),
              f"render_path {name}: launches {launches} for {len(path)} "
              "poses")
    for name, fr in frames.items():
        check(all(np.isfinite(f).all() and f.shape == (3, cam.height,
                                                       cam.width)
                  for f in fr), f"a {name} frame is not finite")
        pngs = sorted((tmp / name).glob("path_*.png"))
        check(len(pngs) == len(fr) and all(
            np.array_equal(read_png(str(p)),
                           (f.transpose(1, 2, 0) * 255).astype(np.uint8))
            for p, f in zip(pngs, fr)),
            f"the {name} PNGs do not decode to their frames")
    # each segment start: the path frame against the render at the trained
    # keypose. The interpolated pose differs from the keypose by float
    # rounding (~6e-8), which moves a few pixels by a few thousandths; a
    # wrong path moves whole frames. So: at most 1e-4 of the values differ
    # by more than 1/255 (one 8-bit level).
    starts = []
    for k in range(len(train) - 1):
        pose = paths["interpolate"][k * fps]
        key = render_view(field, keyposes[k], cam)["render"].clamp(0, 1)
        diff = (key.cpu() - torch.from_numpy(
            frames["interpolate"][k * fps])).abs()
        starts.append({
            "frame": train[k],
            "pose_max_abs_diff": float(np.abs(pose - keyposes[k]).max()),
            "keypose_render_max_abs_diff": float(diff.max()),
            "keypose_render_share_over_1_255": float(
                (diff > 1 / 255).double().mean())})
    check(all(s["pose_max_abs_diff"] < 1e-5 for s in starts),
          f"segment starts moved off their keyposes: {starts}")
    check(all(s["keypose_render_share_over_1_255"] <= 1e-4 for s in starts),
          f"render_path frames differ from their keyposes' renders: "
          f"{starts}")

    # 2. GSViewer on a stub server
    server = StubServer()
    viewer = GSViewer(server, lambda: field, lambda: w2c_all[train[-1]], cam,
                      get_frame_pose=lambda t: w2c_all[t],
                      num_frames=FULLRES_FRAMES,
                      export_dir=str(tmp / "render_path"),
                      start_playback_thread=False)
    client = server.connect()
    rc.reset_launches()
    t1 = time.time()
    viewer.update_render(client)
    viewer.playback_tick()
    add = server.gui.elems["Add camera keyframe"]
    add.click()
    client.camera.position = [0.3, 0.0, 0.0]
    add.click()
    viewer.export_path()
    torch.cuda.synchronize()
    steps["viewer"] = time.time() - t1
    launches["viewer"] = dict(rc.LAUNCHES)
    shown = client.scene.backgrounds
    exported = sorted(p.name for p in (tmp / "render_path").glob("*.png"))
    check(len(shown) == 2 and all(b.shape == (cam.height, cam.width, 3)
                                  and b.dtype == np.uint8 for b in shown),
          f"viewer backgrounds {[b.shape for b in shown]}")
    check(server.gui.elems["frame"].value == 1
          and len(exported) == 10
          and server.gui.elems["keyframes"].value == "exported 10 frames",
          f"viewer state: slider {server.gui.elems['frame'].value}, "
          f"{exported}, {server.gui.elems['keyframes'].value}")
    check(launches["viewer"] == launch_counts(12, 0),
          f"viewer launches {launches['viewer']} != 12 renders")

    # 3. a Trainer with a viewer, one global chunk on the trained map
    tr = Trainer(seq, TrainConfig(global_iters=FULLRES_GLOBAL, rebin_every=4),
                 global_chunk=FULLRES_CHUNK, log_fn=lambda s: None,
                 device=dev, validation_every=0)
    tr.restore(str(ckpt))
    spy = ReportSpy()
    tr.viewer = spy
    rc.reset_launches()
    t1 = time.time()
    tr.global_run(FULLRES_CHUNK)
    torch.cuda.synchronize()
    steps["trainer_with_viewer"] = time.time() - t1
    launches["viz_trainer"] = dict(rc.LAUNCHES)
    check(len(spy.reports) == 1 and math.isfinite(spy.reports[0][0])
          and spy.reports[0][0] > 0, f"viewer reports {spy.reports}")
    check(launches["viz_trainer"] == launch_counts(FULLRES_CHUNK,
                                                   FULLRES_CHUNK),
          f"Trainer launches {launches['viz_trainer']}")
    phase("viz", t0, nvidia_smi=smi, step_seconds=steps,
          path_lengths={k: len(v) for k, v in paths.items()},
          segment_starts=starts, viewer_exported=len(exported),
          viewer_reports=spy.reports, launches=launches, **res)
    return launches


# The bench phase: the repo's measuring and evaluation programs, in
# process at their full default widths (bench.py's scene: 100k Gaussians,
# SH3, 1280x1024), and eval_ckpt on fullres's ckpt_final with a short
# refinement.
EVAL_REFINE_ITERS = 20
EVAL_GATE_KEYS = ("psnr", "ssim", "ate")


def run_bench(dev, smi: str, tmp: Path) -> dict:
    """The four programs through their own ``run``: the bench (raw and
    amortized rates), the mapping-step bench with one view and with two,
    stage timing, and ``eval_ckpt`` on fullres's ``ckpt_final``. Each
    prints its JSON line here (``bench_program``: its name); counters reset
    just before each and read just after, its launches = the renders it
    reports. Gates: each program's own (overflow 0, finite outputs; the
    amortized binnings ceil(iters / 4) a window), the device label = the
    card's, the stages' kernel times rising from stage to stage, and
    eval_ckpt's validation = fullres's final one from the same
    checkpoint, its pose-refined PSNR finite. Returns the launches."""
    import torch
    from freesurgs_tpu_torch import bench
    from freesurgs_tpu_torch.cli import (bench_train_step, eval_ckpt,
                                         stage_timing)
    from freesurgs_tpu_torch.ops import raster_cuda as rc

    t0 = time.time()
    launches, steps, lines = {}, {}, {}

    def program(name: str, fn, *args):
        rc.reset_launches()
        t1 = time.time()
        (line, diag), log = quiet(fn, *args)
        torch.cuda.synchronize()
        steps[name] = time.time() - t1
        launches[name] = dict(rc.LAUNCHES)
        bwd = diag["renders"]["bwd"]
        want = launch_counts(diag["renders"]["fwd"], bwd,
                             projections=diag.get("projections", 0),
                             poses=bwd if name == "eval_ckpt" else 0)
        check(launches[name] == want,
              f"{name} launches {launches[name]} != renders {want}")
        check(line["device"] == smi, f"{name} device {line['device']}")
        print(json.dumps({"bench_program": name, **line}), flush=True)
        lines[name] = line
        return line, diag, log

    line, diag, _ = program("bench", bench.run, str(dev))
    check(diag["amortized_binnings"] == math.ceil(
        bench.ITERS / bench.REBIN_EVERY), f"bench binnings {diag}")
    check(all(math.isfinite(line[k]) and line[k] > 0 for k in (
        "value", "amortized_train_mpix_per_s", "ms_per_iter_median")),
        f"bench line {line}")
    bench_diag = diag
    for views, argv in (("one_view", []), ("two_views", ["--two-views"])):
        line, diag, _ = program(f"bench_train_step_{views}",
                                bench_train_step.run,
                                bench_train_step.parse(
                                    argv + ["--device", str(dev)]))
        check(math.isfinite(line["value"]) and line["value"] > 0
              and math.isfinite(diag["loss"]), f"mapping step {line}")
    line, diag, _ = program("stage_timing", stage_timing.run,
                            stage_timing.parse(["--device", str(dev)]))
    # the nested stages' device work must rise stage to stage; the event
    # and host times are printed with their deltas, not gated: they follow
    # the host, whose ~2 ms of jitter a call exceeds the smaller deltas
    kern = [r["kernel_ms"] for r in line["stages"]]
    check(all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in line["stages"])
          and all(b > a > 0 for a, b in zip(kern, kern[1:])),
          f"stage kernel times do not rise stage to stage: {kern}")

    data, out = tmp / "fullres", tmp / "cfg34"
    final = json.loads((out / "summary.json").read_text())
    line, diag, log = program("eval_ckpt", eval_ckpt.run, eval_ckpt.parse([
        "--ckpt", str(out / "ckpt_final"), "--data", str(data), "--frames",
        str(FULLRES_FRAMES), "--refine_iters", str(EVAL_REFINE_ITERS),
        "--device", str(dev)]))
    check(diag["overflow"] == 0, f"eval_ckpt overflow {diag['overflow']}")
    check(all(line[k] == final[k] for k in EVAL_GATE_KEYS),
          f"eval_ckpt validation {[line[k] for k in EVAL_GATE_KEYS]} != "
          f"fullres's final {[final[k] for k in EVAL_GATE_KEYS]}")
    check(math.isfinite(line["psnr_test_pose_refined"]),
          f"pose-refined PSNR {line['psnr_test_pose_refined']}")
    phase("bench", t0, nvidia_smi=smi, step_seconds=steps,
          launches=launches, bench_instances=bench_diag["num_instances"],
          bench_ms_per_iter=bench_diag["ms_per_iter"],
          bench_amortized_ms_per_iter=bench_diag["amortized_ms_per_iter"],
          eval_ckpt_vs_fullres={k: [line[k], final[k]]
                                for k in EVAL_GATE_KEYS})
    return launches


# The parallel phase: the slice's scene band-sharded over 2 ranks that
# share this card (gloo: NCCL refuses two ranks on one device), its
# Trainer trimmed to 3 frames (frame 1 the test frame) and 4 global
# iterations; the second sequence of (c) is the recipe at another seed.
PARALLEL_RANKS = 2
PARALLEL_FRAMES = 3
PARALLEL_GLOBAL = 4
PARALLEL_SEEDS = (7, 8)
PARALLEL_MAP_ITERS = 2          # (b)'s mapping_chunk, from the init field
PARALLEL_TRACK_ITERS = 3        # (b)'s tracking_loop, after GN
PARALLEL_MULTISEQ_ITERS = 3     # (c)
TRAINER_GATE = (1e-3, 1e-5)     # tests/test_torch_train.py: worst, 99%
STATE_KEYS = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
              "sh_rest", "active", "grad_accum", "grad_denom",
              "max_radii2d")


def state_tensors(tr) -> list:
    f = tr.field
    return [getattr(f, k) for k in STATE_KEYS] + [tr.poses.quats,
                                                  tr.poses.trans]


def gate_errors(got, want) -> tuple[float, float]:
    """The largest |got - want| and its 99th percentile."""
    err = (got.float() - want.float()).abs().reshape(-1)
    if not err.numel():
        return 0.0, 0.0
    k = max(1, math.ceil(0.99 * err.numel()))
    return float(err.max()), float(err.kthvalue(k).values)


def grad_error(got, want) -> float:
    """The largest per-field normalized error of a gradient, its fields
    the trailing entries of each row."""
    n = got.shape[0]
    return max(normalized_field_err(got.reshape(n, -1), want.reshape(n, -1)))


def parallel_grads(render_fn, field, w2c0, cam, weights, **kw):
    """A render of ``field`` (SH degree 3) and the gradients of a weighted
    sum of its render, depth and T_final in the parameters, probe2d and
    the pose."""
    import torch
    names = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
             "sh_rest")
    p = [getattr(field, k).detach().clone().requires_grad_(True)
         for k in names]
    probe = torch.zeros(field.capacity, 2, device=w2c0.device,
                        requires_grad=True)
    w2c = w2c0.detach().clone().requires_grad_(True)
    out = render_fn(*p[:4], torch.cat(p[4:], 1), w2c, cam,
                    active=field.active, probe2d=probe, sh_degree=3, **kw)
    loss = (torch.sum(out["render"] * weights[0])
            + torch.sum(out["render_dep"] * weights[1])
            + torch.sum(out["final_T"] * weights[2]))
    g = torch.autograd.grad(loss, p + [probe, w2c])
    return out, dict(zip(names + ("probe2d", "w2c"), g))


def parallel_rank(rank: int, world: int, backend: str, init_file: str,
                  out_dir: str) -> None:
    """One rank of the parallel phase (spawned; raises on a failed check,
    which fails the phase)."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        # this rank's card: the one card here, which both ranks share
        res = parallel_checks(rank, torch.device(
            "cuda", rank % torch.cuda.device_count()))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def parallel_checks(rank: int, dev) -> dict:
    """Everything one rank measures; run_parallel checks it."""
    import dataclasses

    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import cuda_ms
    from freesurgs_tpu_torch.ops.render import render
    from freesurgs_tpu_torch.parallel.mesh import make_mesh, \
        same_on_all_ranks
    from freesurgs_tpu_torch.parallel.multiseq import (
        multiseq_mapping_chunk, shard_states, stack_states)
    from freesurgs_tpu_torch.parallel.sharded import render_sharded_full
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import (TrainConfig, mapping_chunk,
                                                 tracking_loop)

    def quiet_log(*a):
        pass

    t_setup = time.time()
    mesh = make_mesh(device=dev)                        # 1 x 2: two bands
    mesh_d = make_mesh(data_parallel=PARALLEL_RANKS, device=dev)  # 2 x 1
    cfg = TrainConfig(**SLICE_CFG)
    tkw = dict(SLICE_TRAINER, device=dev, validation_every=0)
    scenes = [slice_sequence(dev, PARALLEL_FRAMES, s) for s in PARALLEL_SEEDS]
    scene, seq = scenes[0]
    cam = seq.cam
    tr = Trainer(seq, cfg, mesh=mesh, log_fn=quiet_log, **tkw)
    field0 = tr.field
    gen = torch.Generator().manual_seed(0)
    weights = [torch.randn(shape, generator=gen).to(dev) for shape in
               ((3, cam.height, cam.width), (cam.height, cam.width),
                (cam.height, cam.width))]
    # (e)'s Trainer: the JAX default's reduction on the bands
    cfg_p = TrainConfig(**SLICE_CFG, grad_sum="prefix")
    tr_p = Trainer(seq, cfg_p, mesh=mesh, log_fn=quiet_log, **tkw)
    # (c)'s states: one per sequence, from a Trainer's init on it
    seq_states = [Trainer(sq, cfg, log_fn=quiet_log, **tkw).state
                  for _, sq in scenes]
    gen_states = [st.generator.get_state() for st in seq_states]
    colors_all = torch.stack([sq.colors for _, sq in scenes])
    monodeps_all = torch.stack([sq.monodeps for _, sq in scenes])
    w2c_all = torch.stack([sc.gt_w2c for sc, _ in scenes])
    torch.cuda.synchronize()
    setup_s = time.time() - t_setup

    # ---- the main path, counters reset just before it
    rc.reset_launches()
    t_run = time.time()
    renders = {"fwd": 0, "bwd": 0, "pose": 0}
    sharded = {}
    for name, sp in (("replicated", False), ("shard_projection", True)):
        sharded[name] = parallel_grads(
            functools.partial(render_sharded_full, mesh,
                              shard_projection=sp),
            field0, scene.gt_w2c[0], cam, weights,
            max_instances=cfg.instance_cap)
    renders["fwd"] += 2
    renders["bwd"] += 2
    renders["pose"] += 2
    launches_a = dict(rc.LAUNCHES)
    # (e) the same renders with grad_sum="prefix": each band's prefix
    # reduction, the bands' sums all-reduced
    sharded_p = {}
    for name, sp in (("replicated", False), ("shard_projection", True)):
        sharded_p[name] = parallel_grads(
            functools.partial(render_sharded_full, mesh,
                              shard_projection=sp, grad_sum="prefix"),
            field0, scene.gt_w2c[0], cam, weights,
            max_instances=cfg.instance_cap)
    renders_p = {"fwd": 2, "bwd": 2, "pose": 2}
    launches_e = {k: rc.LAUNCHES[k] - launches_a[k] for k in rc.LAUNCHES}

    st0 = dataclasses.replace(
        tr.state, generator=torch.Generator().manual_seed(1),
        pred_depths=tr.state.pred_depths.clone(),
        pred_colors=tr.state.pred_colors.clone())
    st, aux = mapping_chunk(st0, tr.colors, tr.monodeps, scene.gt_w2c,
                            [0] * PARALLEL_MAP_ITERS, [], cam, cfg,
                            two_views=False, sh_degree=0, mesh=mesh)
    q0, t0_ = scene.gt_quats[0], scene.gt_trans[0]
    q1, t1, tmet = tracking_loop(
        field0, q0, t0_, tr.colors[1], tr.state.pred_depths[0],
        scene.gt_w2c[0], tr.flows_fw[0],
        torch.ones(cam.height, cam.width, device=dev), cam,
        cfg._replace(tracking_iters=PARALLEL_TRACK_ITERS), sh_degree=0,
        mesh=mesh)
    renders["fwd"] += PARALLEL_MAP_ITERS + PARALLEL_TRACK_ITERS
    renders["bwd"] += PARALLEL_MAP_ITERS + PARALLEL_TRACK_ITERS
    renders["pose"] += PARALLEL_TRACK_ITERS

    psnr_before = psnr(tr.render_frame(0)["render"], seq.colors[0])
    t1_ = time.time()
    tr.progressive_run()
    tr.global_run(PARALLEL_GLOBAL)
    torch.cuda.synchronize()
    trainer_s = time.time() - t1_
    psnr_after = psnr(tr.state.pred_colors[0].float(), seq.colors[0])
    fwd, bwd, _ = progressive_counts(cfg, seq)
    renders["fwd"] += 1 + fwd + PARALLEL_GLOBAL
    renders["bwd"] += bwd + PARALLEL_GLOBAL
    renders["pose"] += tracking_renders(cfg, seq)

    psnr_p_before = psnr(tr_p.render_frame(0)["render"], seq.colors[0])
    tr_p.progressive_run()
    psnr_p_after = psnr(tr_p.state.pred_colors[0].float(), seq.colors[0])
    fwd_p, bwd_p, _ = progressive_counts(cfg_p, seq)
    renders_p["fwd"] += 1 + fwd_p
    renders_p["bwd"] += bwd_p
    renders_p["pose"] += tracking_renders(cfg_p, seq)

    ms_state, ms_aux = multiseq_mapping_chunk(
        mesh_d, shard_states(mesh_d, stack_states(seq_states)),
        colors_all, monodeps_all, w2c_all,
        torch.zeros(PARALLEL_RANKS, PARALLEL_MULTISEQ_ITERS,
                    dtype=torch.int64), cam, cfg, sh_degree=0)
    renders["fwd"] += PARALLEL_MULTISEQ_ITERS
    renders["bwd"] += PARALLEL_MULTISEQ_ITERS
    torch.cuda.synchronize()
    run_s = time.time() - t_run
    launches = dict(rc.LAUNCHES)
    # ---- end of the main path

    res = {"rank": rank, "setup_seconds": setup_s, "run_seconds": run_s,
           "trainer_seconds": trainer_s, "launches": launches,
           "launches_a": launches_a,
           "expected_launches": {
               k: v + launch_counts(renders_p["fwd"], renders_p["bwd"],
                                    prefix=True, poses=renders_p["pose"])[k]
               for k, v in launch_counts(renders["fwd"], renders["bwd"],
                                         poses=renders["pose"]).items()},
           "launches_e": launches_e,
           "prefix_psnr_frame0_before": psnr_p_before,
           "prefix_psnr_frame0_after_mapping": psnr_p_after,
           "prefix_active_gaussians": int(tr_p.field.num_active),
           "init_gaussians": int(field0.num_active),
           "map_loss": float(aux["loss"]),
           "map_field_moved": float((st.field.means
                                     - field0.means).abs().sum()),
           "pose_moved": float(torch.linalg.norm(t1 - t0_)
                               + torch.linalg.norm(q1 - q0)),
           "gn_weight": float(tmet["gn_weight"]),
           "psnr_frame0_before": psnr_before,
           "psnr_frame0_after_mapping": psnr_after,
           "active_gaussians": int(tr.field.num_active),
           "history": [{k: float(v) for k, v in h.items()
                        if k in ("frame", "iter", "loss", "gn_weight",
                                 "gn_resid_px", "num_active")}
                       for h in tr.history],
           "multiseq_loss": ms_aux["loss"].tolist()}

    # (a) against the single-process render on this card
    ref = parallel_grads(render, field0, scene.gt_w2c[0], cam, weights,
                         max_instances=cfg.instance_cap)
    res["a"] = {}
    for name, (out, grads) in sharded.items():
        chans = [(out["render"][c].detach(), ref[0]["render"][c].detach())
                 for c in range(3)]
        chans += [(out[k].detach(), ref[0][k].detach())
                  for k in ("render_dep", "render_sil", "final_T")]
        res["a"][name] = {
            "channel_max_abs_err": [float((a - b).abs().max())
                                    for a, b in chans],
            "channel_scale": [max(1.0, float(b.abs().max()))
                              for _, b in chans],
            "grad_normalized_err": {k: grad_error(g, ref[1][k])
                                    for k, g in grads.items()},
            "bitwise_image": all(torch.equal(a, b) for a, b in chans),
            "radii_equal": torch.equal(out["radii"], ref[0]["radii"]),
            "overflow": int(out["overflow"]),
            "num_instances": int(out["num_instances"]),
            "band_num_instances": out["band_num_instances"].tolist(),
            "single_num_instances": int(ref[0]["num_instances"])}

    # (e) against the single-process "prefix" render: each band's layout
    # has a prefix sum of its own, so the gradients part by that rounding
    ref_p = parallel_grads(render, field0, scene.gt_w2c[0], cam, weights,
                           max_instances=cfg.instance_cap, grad_sum="prefix")
    res["e"] = {}
    for name, (out, grads) in sharded_p.items():
        chans = [(out["render"][c].detach(), ref_p[0]["render"][c].detach())
                 for c in range(3)]
        chans += [(out[k].detach(), ref_p[0][k].detach())
                  for k in ("render_dep", "render_sil", "final_T")]
        res["e"][name] = {
            "channel_max_abs_err": [float((a - b).abs().max())
                                    for a, b in chans],
            "channel_scale": [max(1.0, float(b.abs().max()))
                              for _, b in chans],
            "grad_normalized_err": {k: grad_error(g, ref_p[1][k])
                                    for k, g in grads.items()},
            "grad_normalized_err_vs_direct_bands": {
                k: grad_error(g, sharded[name][1][k])
                for k, g in grads.items()},
            "radii_equal": torch.equal(out["radii"], ref_p[0]["radii"]),
            "overflow": int(out["overflow"])}

    # (b) the ranks' states, and a Trainer without a mesh (rank 0)
    res["ranks_bitwise_equal"] = same_on_all_ranks(
        state_tensors(tr) + [st.field.means, q1, t1] + state_tensors(tr_p)
        + [g for _, grads in sharded_p.values() for g in grads.values()])
    if rank == 0:
        single = Trainer(seq, cfg, log_fn=quiet_log, **tkw)
        single.progressive_run()
        single.global_run(PARALLEL_GLOBAL)
        res["single_history"] = [
            {k: float(v) for k, v in h.items()
             if k in ("frame", "iter", "loss", "gn_weight", "gn_resid_px",
                      "num_active")} for h in single.history]
        res["single_active_gaussians"] = int(single.field.num_active)
        if single.field.capacity == tr.field.capacity:
            res["trainer_gate"] = {
                k: gate_errors(a, b) for k, a, b in zip(
                    STATE_KEYS + ("pose_quats", "pose_trans"),
                    state_tensors(tr), state_tensors(single))}
    mesh.barrier()

    # (c) this rank's sequence against its single-process run
    i = mesh_d.data_index
    gen_i = torch.Generator()
    gen_i.set_state(gen_states[i])
    st_i = dataclasses.replace(
        seq_states[i], generator=gen_i,
        pred_depths=seq_states[i].pred_depths.clone(),
        pred_colors=seq_states[i].pred_colors.clone())
    sc_i, sq_i = scenes[i]
    st_i, aux_i = mapping_chunk(st_i, sq_i.colors, sq_i.monodeps,
                                sc_i.gt_w2c, [0] * PARALLEL_MULTISEQ_ITERS,
                                [], cam, cfg, two_views=False, sh_degree=0)
    res["multiseq_index"] = i
    res["multiseq_bitwise_single"] = all(
        torch.equal(getattr(ms_state.field, k), getattr(st_i.field, k))
        for k in STATE_KEYS) and float(aux_i["loss"]) == \
        res["multiseq_loss"][i]

    # (d) ms per fwd+bwd: the sharded render on both ranks at once, then
    # the single-process render on rank 0 alone
    mesh.barrier()
    res["sharded_fwd_bwd_ms"] = cuda_ms(lambda: parallel_grads(
        functools.partial(render_sharded_full, mesh, shard_projection=False),
        field0, scene.gt_w2c[0], cam, weights,
        max_instances=cfg.instance_cap), iters=5, warmup=1)
    mesh.barrier()
    if rank == 0:
        res["single_fwd_bwd_ms"] = cuda_ms(lambda: parallel_grads(
            render, field0, scene.gt_w2c[0], cam, weights,
            max_instances=cfg.instance_cap), iters=5, warmup=1)
    mesh.barrier()
    return res


def run_parallel(dev, smi: str) -> dict:
    """Spawn the ranks on this card, then report and check their results;
    the parallel path's launches are the ranks' summed."""
    import torch
    import torch.multiprocessing as tmp
    from freesurgs_tpu_torch.parallel.mesh import backend_for

    t0 = time.time()
    torch.cuda.empty_cache()
    backend = backend_for(PARALLEL_RANKS, dev)
    with tempfile.TemporaryDirectory() as d:
        tmp.start_processes(parallel_rank,
                            args=(PARALLEL_RANKS, backend,
                                  str(Path(d) / "init"), d),
                            nprocs=PARALLEL_RANKS, join=True,
                            start_method="spawn")
        ranks = [json.loads((Path(d) / f"rank{r}.json").read_text())
                 for r in range(PARALLEL_RANKS)]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    phase("parallel", t0, nvidia_smi=smi, backend=backend,
          ranks=PARALLEL_RANKS, launches=launches, per_rank=ranks)
    r0 = ranks[0]
    for r in ranks:
        n = r["rank"]
        check(r["init_gaussians"] == 131_072, "expected 131,072 Gaussians")
        check(r["launches"] == r["expected_launches"],
              f"rank {n}: launches {r['launches']} != renders made "
              f"{r['expected_launches']}")
        check(r["launches_a"] == launch_counts(2, 2, poses=2),
              f"rank {n}: (a) launched {r['launches_a']}")
        check(r["launches_e"] == launch_counts(2, 2, prefix=True, poses=2),
              f"rank {n}: (e) launched {r['launches_e']}")
        for name, e in r["e"].items():
            check(all(x <= FWD_CHANNEL_TOL * sc for x, sc in
                      zip(e["channel_max_abs_err"], e["channel_scale"])),
                  f"rank {n} (e) {name}: channel errors "
                  f"{e['channel_max_abs_err']}")
            check(all(x <= PREFIX_VS_DIRECT_TOL
                      for x in e["grad_normalized_err"].values()),
                  f"rank {n} (e) {name}: gradient errors "
                  f"{e['grad_normalized_err']}")
            check(e["overflow"] == 0 and e["radii_equal"],
                  f"rank {n} (e) {name}: overflow or radii")
        check(r["prefix_psnr_frame0_after_mapping"]
              > r["prefix_psnr_frame0_before"],
              f"rank {n}: (e) frame-0 PSNR did not improve")
        for name, a in r["a"].items():
            check(all(e <= FWD_CHANNEL_TOL * s for e, s in
                      zip(a["channel_max_abs_err"], a["channel_scale"])),
                  f"rank {n} (a) {name}: channel errors "
                  f"{a['channel_max_abs_err']}")
            check(all(e <= BWD_FIELD_TOL
                      for e in a["grad_normalized_err"].values()),
                  f"rank {n} (a) {name}: gradient errors "
                  f"{a['grad_normalized_err']}")
            check(a["overflow"] == 0 and a["radii_equal"],
                  f"rank {n} (a) {name}: overflow or radii")
        check(r["map_loss"] > 1e-3 and r["map_field_moved"] > 0,
              f"rank {n}: mapping under the mesh: loss {r['map_loss']}, "
              f"moved {r['map_field_moved']}")
        check(r["pose_moved"] > 0 and r["gn_weight"] >= GN_MIN_WEIGHT,
              f"rank {n}: tracking under the mesh: pose moved "
              f"{r['pose_moved']}, GN weight {r['gn_weight']}")
        check(r["psnr_frame0_after_mapping"] > r["psnr_frame0_before"],
              f"rank {n}: frame-0 PSNR did not improve")
        check(r["ranks_bitwise_equal"], "the ranks' states differ")
        check(r["multiseq_bitwise_single"] and r["multiseq_index"] == n,
              f"rank {n}: its sequence differs from its single run")
        check(r["multiseq_loss"] == r0["multiseq_loss"],
              "the ranks gathered different multi-sequence losses")
    check(r0["single_active_gaussians"] == r0["active_gaussians"]
          and "trainer_gate" in r0,
          f"the mesh Trainer ends with {r0['active_gaussians']} Gaussians, "
          f"the Trainer without one {r0['single_active_gaussians']}")
    check(all(w <= TRAINER_GATE[0] and q <= TRAINER_GATE[1]
              for w, q in r0["trainer_gate"].values()),
          f"Trainer gate: {r0['trainer_gate']}")
    return {"parallel": launches}


def ptxas_report(reports: dict[str, str]) -> dict:
    """Registers, shared memory and spills of each compiled kernel; the
    ablation's template instances are named by their variant."""
    from freesurgs_tpu_torch.ops.raster_ablate import VARIANTS
    by_switches = {(m.stop, m.rect_mask, m.bulk, m.quad, not m.linear_t):
                   name for name, m in VARIANTS.items()}
    out = {}
    for lib, rep in reports.items():
        for block in rep.split("Compiling entry function")[1:]:
            fn = block.split("'")[1]
            switches = tuple(b == "1" for b in re.findall(r"Lb([01])E", fn))
            name = (f"composite_fwd_ablate.{by_switches[switches]}"
                    if "ablate" in fn else lib)
            if lib == "gaussian_grad_prefix":
                name += "." + re.search(r"\d+([a-z_]+_kernel)E", fn).group(1)
            if lib == "project":      # project_<fwd|bwd|pose>_kernel<...>
                kern = re.search(r"\d+(project_[a-z]+)_kernel", fn).group(1)
                targs = re.findall(r"L([ib])(\d+)E", fn)
                name = kern + "".join(f".{a}" for _, a in targs)
            regs = re.findall(r"Used (\d+) registers", block)
            smem = re.findall(r"(\d+) bytes smem", block)
            spill = re.findall(r"(\d+) bytes spill stores", block)
            out[name] = {"registers": int(regs[0]) if regs else None,
                         "smem_bytes": int(smem[0]) if smem else 0,
                         "spill_store_bytes": int(spill[0]) if spill else 0}
    return out


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
    # full f32 everywhere (SSIM's variance cancellation, the GN normal
    # equations, the 3-NN matmul, LPIPS's convolutions)
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

    from freesurgs_tpu_torch.bench import bench_scene
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import records_for
    t0 = time.time()
    reports = rc.build_kernels()
    phase("build", t0, built=sorted(reports), ptxas=ptxas_report(reports))
    run_ssim(dev, smi)

    cam, params = bench_scene(dev)
    bench = (cam,) + records_for(cam, params)
    results: dict = {}
    kernel_checks(dev, "bench_scene", cam.height, cam.width, *bench[1:])
    results["kernels"] = []
    row = project_checks(dev)
    results["kernels"] += [
        {"name": name, "route": "cuda",
         "source": "freesurgs_tpu_torch/csrc/project.cu",
         "replaces": PROJECT_REPLACES, "launches": 0,
         "ms": row[f"{d}_ms"], "bound_ms": row[f"{d}_bound_ms"],
         "share_of_bound": row[f"{d}_share_of_bound"],
         "plain_ms": row["plain_fwd_ms" if d == "fwd" else
                         "plain_fwd_bwd_ms"]}
        for name, d in (("project_fwd", "fwd"), ("project_bwd", "bwd"))]
    run_ablate(bench, results)
    del bench
    cfg_p, *records_p = records_for(cam, params, grad_sum="prefix")
    prefix_checks(dev, "bench_scene", cam.height, cam.width, cfg_p,
                  *records_p)
    del params, records_p
    prefix_synthetic(dev)
    with tempfile.TemporaryDirectory() as ckpt_root:
        slice_summary = run_slice(dev, results, Path(ckpt_root))
    paths = {"slice": slice_summary["launches"],
             **run_prefix(dev, results),
             "reuse": run_reuse(dev, slice_summary),
             "overlap": run_overlap(dev),
             "cli": run_cli(dev, smi, slice_summary)}
    paths.update(run_raw(dev, smi))
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(run_fullres(dev, smi, Path(tmp)))
        paths.update(run_tpu_rows(dev, smi, Path(tmp)))
        paths.update(run_viz(dev, smi, Path(tmp)))
        paths.update(run_bench(dev, smi, Path(tmp)))
    paths.update(run_parallel(dev, smi))
    # K1 / K2 / the sum / the prefix reduction's launches: the sum over
    # the paths, each counted alone
    for row in results["kernels"]:
        if row["name"] in rc.LAUNCHES:
            row["launches"] = sum(p[row["name"]] for p in paths.values())
    print(json.dumps({"launches_by_path": paths}), flush=True)
    print(json.dumps({"kernels": results["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
