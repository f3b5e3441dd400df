"""BASELINE configs 3-4 end to end with a wall-clock budget (port of
``scripts/run_config34.py``).

  python -m freesurgs_tpu_torch.cli.run_config34 --data <dir> --out <dir> \
      [--frames 46] [--budget_s 1500] [--global_iters 6000] \
      [--global_chunk 250] [--rebin_every 4] [--save_ckpt] \
      [--checkpoint_every 5000] [--resume <ckpt>] [--pose_ba_final N] \
      [--grad_sum direct|prefix] [--device cuda|cpu] ...

Runs the reference schedule (progressive tracking + mapping per frame,
then the global refinement stage, reference ``train.py:318-443``) on the
full-res synthetic SCARED stand-in of ``cli.make_fullres_dataset``,
time-boxing the global stage: it runs in chunks of ``--global_chunk`` and
stops when the budget (progressive + global) is spent. ``summary.json``
records the iterations completed, the stage seconds and the final
validation (PSNR / SSIM / LPIPS and sim(3)-aligned ATE / RPE, reference
``train.py:446-515``), with the JAX script's keys.

Differences from the JAX script: ``final_max_instances`` holds
``cfg.max_instances``, where 0 means the port sizes each render's
instance buffer exactly (up to ``max_instances_cap``); there is no
``right_size_instances`` before the final pose BA; and a failure of
``--pose_ba_final`` is not caught: it propagates and the command exits
non-zero, after ``summary.json`` is on disk; ``--data`` and ``--out``
are required (the JAX script defaults them to fixed paths under /tmp);
``--grad_sum`` picks the backward's per-Gaussian reduction, "direct" by
default, where the JAX script always takes its default ("prefix", its
fast binner's; the summary's keys stay the JAX script's). Runs on the
card unless
``--device cpu``; without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.transforms import rotmat_to_quat
from ..data.scared import load_scared
from ..io.cameras_json import save_cameras_json
from ..io.ply import field_to_ply
from ..models.pose import PoseTable
from ..train.loop import Trainer
from ..train.steps import TrainConfig
from ..utils.logging import MetricsLogger
from ..utils.profiling import resolve_device


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True,
                    help="the recipe's SCARED-layout directory "
                         "(cli.make_fullres_dataset --out)")
    ap.add_argument("--out", required=True,
                    help="run directory: summary.json, metrics, "
                         "checkpoints")
    ap.add_argument("--frames", type=int, default=46)
    ap.add_argument("--budget_s", type=float, default=1500.0,
                    help="total training wall-clock budget (progressive + "
                         "global); the global stage is cut to fit")
    ap.add_argument("--global_iters", type=int, default=6000)
    ap.add_argument("--global_chunk", type=int, default=250)
    ap.add_argument("--rebin_every", type=int, default=4)
    ap.add_argument("--rebin_tracking_every", type=int, default=1)
    ap.add_argument("--save_ckpt", action="store_true",
                    help="save the final checkpoint, point_cloud.ply and "
                         "cameras.json")
    ap.add_argument("--checkpoint_every", type=int, default=5000,
                    help="mid-global checkpoint cadence (crash resume; "
                         "0 disables)")
    ap.add_argument("--resume", default="",
                    help="checkpoint path to resume from: skips the "
                         "progressive stage and continues the global "
                         "stage at the checkpoint's iteration")
    ap.add_argument("--tracking_gn_iters", type=int, default=8,
                    help="Gauss-Newton flow-PnP iterations before the "
                         "photometric Adam tracking refinement "
                         "(train/flow_pnp.py); 0 = exact reference "
                         "tracking semantics")
    ap.add_argument("--keyframe_policy", default="uniform",
                    choices=["uniform", "overlap"],
                    help="second-mapping-view selection: 'uniform' random "
                         "keyframe (reference train.py:236-244) or "
                         "'overlap' (the reference's viewpoint-overlap "
                         "variant, scene/pose_optimizer.py:534-577)")
    ap.add_argument("--pose_init", default="const_velocity",
                    choices=["const_velocity", "pnp"],
                    help="tracking pose init for frames t>1 (the "
                         "reference's initialize_pose pnp flag, "
                         "scene/pose_optimizer.py:498-532)")
    ap.add_argument("--pose_ba_every", type=int, default=0,
                    help="global-stage pose-BA cadence (0 = off): every N "
                         "global iters, photometrically refine train-frame "
                         "poses against the frozen map (monotone "
                         "best-pose)")
    ap.add_argument("--pose_ba_iters", type=int, default=25)
    ap.add_argument("--pose_ba_lr", type=float, default=1e-3)
    ap.add_argument("--pose_ba_final", type=int, default=0,
                    help="AFTER the main summary is written: N monotone "
                         "pose-BA passes against the final map, then "
                         "re-validate and write summary_ba.json; a failure "
                         "here exits non-zero with summary.json kept")
    ap.add_argument("--pose_ba_polish", type=int, default=0,
                    help="global mapping iterations run after each final "
                         "BA pass (lets the map adapt to the moved poses "
                         "before the re-validation)")
    ap.add_argument("--depth_prior", default="normalized",
                    choices=["normalized", "metric"],
                    help="depth-prior handling in the loader: 'normalized'"
                         " is reference parity (per-frame [0.5,1.5] affine"
                         " remap), 'metric' keeps 1/disparity as-is")
    ap.add_argument("--use_gt_poses", action="store_true",
                    help="DIAGNOSTIC: skip tracking and train the map at "
                         "ground-truth poses (the map-quality ceiling; pose "
                         "metrics become trivially zero)")
    ap.add_argument("--grad_sum", default="direct",
                    choices=("direct", "prefix"),
                    help="the training renders' backward per-Gaussian "
                         "reduction: direct, or prefix (the JAX package's "
                         "default, fast_binning=True)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _scalars(metrics: dict, prefix: str = "") -> dict:
    """The metrics a summary keeps: numbers (rounded to 5 decimals if
    floats) and strings. The port's validation ``overflow`` stays out, as
    the JAX validation has none (the Trainer logs a warning for it)."""
    return {prefix + k: (round(float(v), 5)
                         if isinstance(v, (float, np.floating)) else v)
            for k, v in metrics.items()
            if k != "overflow" and isinstance(
                v, (int, float, np.integer, np.floating, str))}


def inject_gt_poses(trainer: Trainer, seq) -> None:
    """Set every pose to the ground truth relative to frame 0 (frame 0's
    camera frame is the world frame) and turn tracking off."""
    gt = np.concatenate([np.asarray(v) for v in seq.gt_poses.values()])
    rel = gt @ np.linalg.inv(gt[0])
    dev = trainer.poses.quats.device
    rel_t = torch.as_tensor(rel.astype(np.float32), device=dev)
    trainer.poses = PoseTable(quats=rotmat_to_quat(rel_t[:, :3, :3]),
                              trans=rel_t[:, :3, 3].clone())
    trainer.track_frame = lambda t: {}


def main(argv=None) -> int:
    args = parse(argv)
    dev = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    seq = load_scared(args.data, 0, args.frames, sample_rate=8,
                      depth_prior=args.depth_prior)
    print(f"loaded {seq.num_frames} frames {seq.cam.width}x{seq.cam.height},"
          f" {len(seq.i_train)} train / {len(seq.i_test)} test", flush=True)

    cfg = TrainConfig(global_iters=args.global_iters,
                      rebin_every=args.rebin_every,
                      rebin_tracking_every=args.rebin_tracking_every,
                      tracking_gn_iters=args.tracking_gn_iters,
                      keyframe_policy=args.keyframe_policy,
                      grad_sum=args.grad_sum)
    trainer = Trainer(seq, cfg, global_chunk=args.global_chunk,
                      log_fn=lambda m: print(m, flush=True),
                      pose_init=args.pose_init,
                      pose_ba_every=args.pose_ba_every,
                      pose_ba_iters=args.pose_ba_iters,
                      pose_ba_lr=args.pose_ba_lr,
                      metrics_logger=MetricsLogger(args.out),
                      checkpoint_dir=(args.out if args.checkpoint_every
                                      else None),
                      checkpoint_every=args.checkpoint_every or 5000,
                      device=dev)

    if args.use_gt_poses:
        inject_gt_poses(trainer, seq)
        print("DIAGNOSTIC: ground-truth poses injected, tracking OFF",
              flush=True)

    summary = {"frames": args.frames,
               "use_gt_poses": bool(args.use_gt_poses),
               "tracking_gn_iters": args.tracking_gn_iters,
               "keyframe_policy": args.keyframe_policy,
               "pose_init": args.pose_init,
               "pose_ba_every": args.pose_ba_every,
               "depth_prior": args.depth_prior,
               "rebin_every": args.rebin_every,
               "rebin_tracking_every": args.rebin_tracking_every,
               "init_active": int(trainer.field.num_active),
               "capacity": int(trainer.field.capacity),
               "max_instances": int(trainer.cfg.max_instances)}

    t0 = time.time()
    if args.resume:
        trainer.restore(args.resume)
        done0 = trainer._global_done
        # a fresh stream offset by the resume point: the default stream
        # would replay the already-trained prefix's frame draws
        trainer._global_rng = np.random.default_rng(trainer.seed + 1 + done0)
        summary["resumed_from"] = args.resume
        summary["resumed_at_global_iter"] = done0
        summary["progressive_s"] = 0.0
        print(f"resumed from {args.resume} at global iter {done0}",
              flush=True)
    else:
        trainer.progressive_run()
        done0 = 0
        summary["progressive_s"] = round(time.time() - t0, 1)
        print(f"progressive done in {summary['progressive_s']}s",
              flush=True)

    tg = time.time()
    done = done0
    while done < args.global_iters and time.time() - t0 < args.budget_s:
        n = min(args.global_chunk, args.global_iters - done)
        trainer.global_run(n)
        done += n
    summary["global_s"] = round(time.time() - tg, 1)
    summary["global_iters_done"] = done
    summary["final_active"] = int(trainer.field.num_active)
    summary["final_capacity"] = int(trainer.field.capacity)
    summary["final_max_instances"] = int(trainer.cfg.max_instances)
    print(f"global {done}/{args.global_iters} in {summary['global_s']}s",
          flush=True)

    if args.save_ckpt:
        trainer.save(os.path.join(args.out, "ckpt_final"))
        field_to_ply(trainer.field, os.path.join(args.out,
                                                 "point_cloud.ply"))
        with torch.no_grad():
            w2cs = trainer.poses.all_w2c().cpu().numpy()
        save_cameras_json(os.path.join(args.out, "cameras.json"), w2cs,
                          trainer.cam, names=seq.image_names)

    tv = time.time()
    metrics = trainer.validation(include_train=True)
    summary["validation_s"] = round(time.time() - tv, 1)
    summary.update(_scalars(metrics))
    summary["total_s"] = round(time.time() - t0, 1)

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)

    if args.pose_ba_final:
        # after the main record is on disk: a failure here costs only this
        # stage, and it is not caught
        tba = time.time()
        for k in range(args.pose_ba_final):
            trainer._pose_ba_pass(done + k)
            if args.pose_ba_polish:
                trainer.global_run(args.pose_ba_polish)
                done += args.pose_ba_polish
        mba = trainer.validation(include_train=True)
        sba = dict(summary)
        sba["pose_ba_final_passes"] = args.pose_ba_final
        sba["pose_ba_polish"] = args.pose_ba_polish
        sba["pose_ba_s"] = round(time.time() - tba, 1)
        sba.update(_scalars(mba, prefix="ba_"))
        with open(os.path.join(args.out, "summary_ba.json"), "w") as f:
            json.dump(sba, f, indent=1)
        print(json.dumps(sba), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
