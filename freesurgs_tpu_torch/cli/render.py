"""Render a trained run's views (port of the root ``render.py``).

  python -m freesurgs_tpu_torch.cli.render --data_source_path <dir> \
      --run_model_path <out> --run_start_checkpoint <out>/ckpt_final \
      [--split test|train|all]

Restores the checkpoint, writes ``<out>/renders/<split>_<t:04d>.png`` (GT |
render | prior depth | rendered depth) for every frame of the split, prints
PSNR / SSIM / LPIPS over them and writes ``<out>/cameras.json``. The
sequence loads with ``--data_depth_prior``, as in training. Runs on the
card unless ``--run_platform cpu``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..data.scared import load_scared
from ..eval.image_metrics import rgb_evaluation
from ..io.cameras_json import save_cameras_json
from ..train.loop import Trainer
from ..utils.image import add_label, colorize_depth, hcat, save_image
from .train import parse


def main(argv=None) -> int:
    cfg, args = parse(argv, __doc__, extra=lambda p: p.add_argument(
        "--split", default="test", choices=["test", "train", "all"]))
    if not cfg.run.start_checkpoint:
        raise ValueError("--run_start_checkpoint is required")
    dev = cfg.device()
    seq = load_scared(cfg.data.source_path, cfg.data.frame_start,
                      cfg.data.frame_end, cfg.data.sample_rate,
                      depth_prior=cfg.data.depth_prior)
    trainer = Trainer(seq, cfg.train_config(),
                      sh_degree_max=cfg.model.sh_degree,
                      capacity=cfg.model.capacity or None, device=dev)
    trainer.restore(cfg.run.start_checkpoint)

    out_dir = os.path.join(cfg.run.model_path, "renders")
    os.makedirs(out_dir, exist_ok=True)
    frames = {"test": seq.i_test, "train": seq.i_train,
              "all": range(seq.num_frames)}[args.split]
    preds, gts = [], []
    for t in [int(i) for i in frames]:
        out = trainer.render_frame(t)
        img = torch.clamp(out["render"], 0, 1).cpu().numpy()
        gt = seq.colors[t]
        preds.append(img)
        gts.append(gt)
        panel = hcat(add_label(gt, "GT rgb"),
                     add_label(img, "Rendered rgb"),
                     add_label(colorize_depth(seq.monodeps[t]),
                               "prior depth"),
                     add_label(colorize_depth(out["render_dep"].cpu()
                                              .numpy()), "Rendered depth"))
        save_image(panel, os.path.join(out_dir, f"{args.split}_{t:04d}.png"))
    if preds:
        m = rgb_evaluation(np.stack(gts), np.stack(preds), device=dev)
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in m.items()}, flush=True)
    with torch.no_grad():
        w2cs = trainer.poses.all_w2c()
    save_cameras_json(os.path.join(cfg.run.model_path, "cameras.json"),
                      w2cs, seq.cam, seq.image_names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
