"""Evaluate a saved checkpoint: test / train PSNR, pose metrics, and the
pose-refined test PSNR that separates map quality from tracked-pose error
(counterpart of ``scripts/eval_ckpt.py``).

    python -m freesurgs_tpu_torch.cli.eval_ckpt --ckpt <dir>/ckpt_final \
        --data <dir> [--frames 46] [--refine_iters 100] [--device cuda|cpu]

Raw test-view PSNR mixes two errors: the map's and the test pose's (test
frames are tracked, never mapped). ``--refine_iters N`` also refines each
test view's pose photometrically against the frozen map
(``eval/pose_refine.refine_pose``) and reports the mean PSNR at the
refined poses (``psnr_test_pose_refined``): the map is not updated, so
that number isolates reconstruction quality.

Prints one JSON line with the JAX script's keys (the validation's numbers,
rounded to 5 decimals, and its strings; ``psnr_test_pose_refined`` and
``refine_iters``) plus ``device`` (the card's name and power limit).
Differences from the JAX script: ``--data`` is required; ``--device``
replaces ``--platform``; the Trainer sizes each render's instance buffer
exactly (the JAX script's ``max_instances=128`` is a placeholder the
checkpoint's sidecar replaces). Every render goes through the compositing
kernels: the validation's forward (K1), the refinement's forward and
backward (K1, K2 and the per-Gaussian sum). Runs on the card unless
``--device cpu``; without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.scared import load_scared
from ..eval.image_metrics import psnr
from ..eval.pose_refine import refine_pose
from ..train.loop import Trainer
from ..train.steps import TrainConfig
from ..utils.profiling import device_label, resolve_device


def run(args) -> tuple[dict, dict]:
    """The evaluation: (the JSON line, diagnostics: renders made, the
    largest overflow of the validation and refinement renders)."""
    dev = resolve_device(args.device)
    seq = load_scared(args.data, 0, args.frames, sample_rate=8)
    trainer = Trainer(seq, TrainConfig(), device=dev,
                      log_fn=lambda m: print(m, flush=True))
    trainer.restore(args.ckpt)
    metrics = trainer.validation(include_train=True)
    overflow = float(metrics.pop("overflow"))
    out = {k: round(float(v), 5) if isinstance(v, (float, np.floating))
           else v for k, v in metrics.items()
           if isinstance(v, (int, float, str, np.floating, np.integer))}
    test = [int(i) for i in seq.i_test]
    fwd = len(test) + len([int(i) for i in seq.i_train][::8])
    bwd = 0

    if args.refine_iters > 0:
        ps = []
        for t in test:
            q, tr_, _, ov, _ = refine_pose(
                trainer.field, trainer.poses.quats[t], trainer.poses.trans[t],
                trainer.colors[t], trainer.cam, iters=args.refine_iters,
                sh_degree=trainer.active_sh_degree,
                max_instances=trainer.cfg.instance_cap,
                grad_sum=args.grad_sum)
            overflow = max(overflow, float(ov))
            trainer.poses = trainer.poses.set_frame(t, q, tr_)
            o = trainer.render_frame(t)
            overflow = max(overflow, float(o["overflow"]))
            p = psnr(trainer.colors[t].cpu().numpy()[None],
                     np.clip(o["render"].cpu().numpy(), 0, 1)[None])
            ps.append(float(p))
            print(f"refined test frame {t}: psnr {p:.2f}", flush=True)
        out["psnr_test_pose_refined"] = round(float(np.mean(ps)), 5)
        out["refine_iters"] = args.refine_iters
        fwd += len(test) * (args.refine_iters + 1)
        bwd += len(test) * args.refine_iters
    out["device"] = device_label(dev)
    return out, {"renders": {"fwd": fwd, "bwd": bwd}, "overflow": overflow}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data", required=True,
                    help="the SCARED-layout directory the run trained on")
    ap.add_argument("--frames", type=int, default=46)
    ap.add_argument("--refine_iters", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--grad_sum", default="direct",
                    choices=("direct", "prefix"),
                    help="the refinement renders' backward reduction "
                         "(ops/raster_cuda.RasterConfig)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    out, _ = run(parse(argv))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
