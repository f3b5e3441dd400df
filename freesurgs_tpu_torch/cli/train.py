"""Train on a SCARED-layout directory (port of the root ``train.py``).

  python -m freesurgs_tpu_torch.cli.train --data_source_path <dir> \
      --run_model_path <out> [--train_override k=v ...]
  ... --run_test true                      # validation only
  ... --run_start_checkpoint <ckpt-dir>    # or "latest"

The flags are the JAX CLI's (``io/config.py``). ``--run_visualize true``
starts the web viewer (``viz/viewer.GSViewer``) on ``--run_port`` when
viser is installed, with path exports under ``<model_path>/render_path``,
and runs headless without it, as the JAX CLI does. The run writes
``config.json``, ``metrics.jsonl``, ``panels/*.png``, ``ckpt_progressive``,
``ckpt_final`` and ``point_cloud.ply`` under ``--run_model_path``. It runs
on the card; ``--run_platform cpu`` runs it on the CPU, and without a CUDA
device it fails rather than falling back.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..data.scared import load_scared
from ..io.checkpoint import latest_checkpoint
from ..io.config import Config, add_to_parser, from_args, save_config
from ..io.ply import field_to_ply
from ..train.loop import Trainer
from ..train.steps import check_supported
from ..utils.logging import MetricsLogger
from ..viz.viewer import GSViewer


def parse(argv, description: str,
          extra=None) -> tuple[Config, argparse.Namespace]:
    """The Config of ``argv`` (and the parsed namespace), refusing what the
    port does not run: an ``--run_impl`` other than the kernels', and the
    card when there is none."""
    parser = argparse.ArgumentParser(description=description)
    cfg = Config()
    add_to_parser(cfg, parser)
    if extra is not None:
        extra(parser)
    args = parser.parse_args(argv)
    cfg = from_args(cfg, args)
    check_supported(cfg.train_config())
    if cfg.device() == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "--run_platform cpu to run on the CPU")
    return cfg, args


def run(cfg: Config, logger: MetricsLogger) -> int:
    seq = load_scared(cfg.data.source_path, cfg.data.frame_start,
                      cfg.data.frame_end, cfg.data.sample_rate,
                      depth_prior=cfg.data.depth_prior)
    logger.info(f"loaded {seq.num_frames} frames "
                f"{seq.cam.width}x{seq.cam.height}, "
                f"{len(seq.i_train)} train / {len(seq.i_test)} test")
    out = cfg.run.model_path
    trainer = Trainer(
        seq, cfg.train_config(), sh_degree_max=cfg.model.sh_degree,
        global_chunk=cfg.run.global_chunk,
        init_mask_frac=cfg.model.init_mask_frac,
        capacity=cfg.model.capacity or None, seed=cfg.run.seed,
        log_fn=logger.info, checkpoint_dir=out,
        checkpoint_every=cfg.run.checkpoint_every,
        panel_fn=logger.log_image, device=cfg.device())

    if cfg.run.visualize:
        viewer = GSViewer.create(
            cfg.run.port, lambda: trainer.field,
            lambda: trainer.poses.w2c(trainer.cur_frame), seq.cam,
            max_instances=cfg.run.max_instances,
            get_frame_pose=lambda t: trainer.poses.w2c(t),
            num_frames=seq.num_frames,
            export_dir=os.path.join(out, "render_path"))
        if viewer is None:
            logger.info("viser not installed; running headless")
        trainer.viewer = viewer

    if cfg.run.start_checkpoint:
        ckpt = cfg.run.start_checkpoint
        if ckpt == "latest":
            ckpt = latest_checkpoint(out)
            if ckpt is None:
                logger.info(f"no checkpoint under {out}")
                return 1
        trainer.restore(ckpt)
        logger.info(f"restored {ckpt} at iteration "
                    f"{trainer.state.iteration}")

    if cfg.run.test:
        logger.log(trainer.validation())
        return 0

    if not cfg.run.start_checkpoint:
        trainer.progressive_run()
        trainer.save(os.path.join(out, "ckpt_progressive"))
    trainer.global_run()
    trainer.save(os.path.join(out, "ckpt_final"))
    field_to_ply(trainer.field, os.path.join(out, "point_cloud.ply"))
    logger.log(trainer.validation())
    logger.info("all complete")
    return 0


def main(argv=None) -> int:
    cfg, _ = parse(argv, __doc__)
    os.makedirs(cfg.run.model_path, exist_ok=True)
    save_config(cfg, os.path.join(cfg.run.model_path, "config.json"))
    logger = MetricsLogger(cfg.run.model_path)
    try:
        with torch.autograd.set_detect_anomaly(cfg.run.debug_nans):
            return run(cfg, logger)
    finally:
        logger.close()


if __name__ == "__main__":
    sys.exit(main())
