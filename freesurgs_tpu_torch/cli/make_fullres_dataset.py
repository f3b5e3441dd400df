"""Generate a full-resolution synthetic sequence in SCARED layout (port of
``scripts/make_fullres_dataset.py``).

  python -m freesurgs_tpu_torch.cli.make_fullres_dataset --out <dir> \
      [--frames 60] [--n 20000] [--hw 1024 1280] [--seed 7] [--nonrigid] \
      [--device cuda|cpu]

BASELINE configs 3-4 need a full-length 1280x1024 sequence; the real
SCARED dataset is access-gated, so the stand-in is the synthetic video at
native resolution: a dense Gaussian scene rendered through the port's
compositing kernel, analytic optical flow from the true depth and the
ground-truth relative poses, and the depth written as disparity
(``data/synthetic.py``, ``data/scared.save_synthetic_as_scared``).
``--nonrigid`` adds a deforming patch and a moving specular highlight and
writes their ground-truth masks as ``<out>/nonrigid_mask.npz``.

The JAX script's fixed ``max_instances=393_216`` has no counterpart: the
port sizes each render's instance buffer exactly, up to the
``max_instances_cap``. The largest instance count a frame needed, and
the instances dropped at the cap (0 unless the cap was reached), are
logged. Runs on the card unless ``--device cpu``; without a CUDA device
it fails.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..data.scared import save_synthetic_as_scared
from ..data.synthetic import make_nonrigid_scene, make_scene
from ..utils.profiling import resolve_device


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--hw", type=int, nargs=2, default=[1024, 1280])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--nonrigid", action="store_true",
                    help="adversarial variant: a deforming patch + a "
                         "moving specular highlight with epipolar-"
                         "violating analytic flow (the rigidity-mask "
                         "stress sequence; GT non-rigid masks are saved "
                         "as <out>/nonrigid_mask.npz)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Write the sequence; returns {"num_instances_max", "overflow_total",
    "render_seconds", "total_seconds"}."""
    args = parse(argv)
    dev = resolve_device(args.device)
    t0 = time.time()
    # scale_range sized for ~10-30 px screen radii at 1280x1024
    # (fx ~ 1.1*W, depths 1.0-2.5)
    common = dict(num_frames=args.frames, n_gaussians=args.n,
                  height=args.hw[0], width=args.hw[1], seed=args.seed,
                  scale_range=(0.004, 0.012), device=dev)
    aux = None
    if args.nonrigid:
        # deformation / highlight speeds scale with the trajectory's
        # per-frame motion (~0.015), staying in the same regime
        scene, aux = make_nonrigid_scene(patch_amp=0.02, spec_speed=0.02,
                                         **common)
    else:
        scene = make_scene(**common)
    inst = int(scene.num_instances.max())
    dropped = int(scene.overflow.sum())
    render_s = time.time() - t0
    log(f"rendered {args.frames} frames {args.hw[1]}x{args.hw[0]} "
        f"in {render_s:.1f}s; largest instance count {inst}, "
        f"instances dropped at the cap {dropped}")
    if dropped:
        log(f"WARNING: {dropped} instances dropped at the max_instances "
            "cap: frames past the cap render with empty suffix tiles")
    save_synthetic_as_scared(scene, args.out)
    if aux is not None:
        np.savez_compressed(
            os.path.join(args.out, "nonrigid_mask.npz"),
            nonrigid_mask=aux["nonrigid_mask"].cpu().numpy(),
            member_patch=aux["member_patch"].cpu().numpy().astype(
                np.float16),
            member_spec=aux["member_spec"].cpu().numpy().astype(
                np.float16))
    total = time.time() - t0
    log(f"wrote {args.out} ({total:.1f}s total)")
    return {"num_instances_max": inst, "overflow_total": dropped,
            "render_seconds": render_s, "total_seconds": total}


if __name__ == "__main__":
    main()
