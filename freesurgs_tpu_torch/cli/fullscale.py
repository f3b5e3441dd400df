"""The full-scale run of the port on one GPU (BASELINE configs 3-4).

    python -m freesurgs_tpu_torch.cli.fullscale --results <dir> [--seed 7]
        [--pose_ba_every N] [--grad_sum direct|prefix]

Generates the full-res recipe with ``cli.make_fullres_dataset --frames
60 --seed <seed>`` (1280x1024, 20,000 Gaussians), then trains it with
``cli.run_config34 --frames 46 --depth_prior metric --rebin_every 4
--global_iters 30000 --global_chunk 250 --tracking_gn_iters 8 --save_ckpt
--pose_ba_final 1 --budget_s 2700`` (cfg34_r5c's settings; the budget
keeps the whole run under an hour; ``--pose_ba_every N`` adds the
mid-global pose BA every N global iterations, cfg34_r5b's arm at 2500,
and the default 0 leaves that argv as it is; ``--grad_sum prefix`` passes
the JAX package's default backward reduction to it and to the
evaluation's refinement, Arm C, and the default "direct" leaves both
argvs as they are), both in this process, on
the card (without a CUDA device it fails), and evaluates ``ckpt_final`` with
``cli.eval_ckpt`` (``--refine_iters 100``): the validation again and the
pose-refined test PSNR, which separates the map's error from the tracked
test poses'. The dataset, checkpoints and PLY stay in a temporary
directory, removed at the end (a checkpoint is too large to keep);
``--results`` receives what is small: ``summary.json`` and
``summary_ba.json`` with ``nvidia_smi`` (the card's name and power limit),
``grad_sum`` (the reduction that ran),
the peak allocated device memory, the largest instance count of any
training render, each stage's iterations per second and the warnings the
Trainer logged; ``eval_ckpt.json``, the evaluation's line; plus
``metrics.jsonl``, ``cameras.json`` and the console log ``train.log``.

Each render's instance count is kept as a running maximum on the device
(no host read during the run). The Trainer's row of each pose-BA pass
(the mid-global ones and the final one, in order, from metrics.jsonl) is
copied under ``pose_ba_passes``: its global iteration, seconds, and the
mean loss at the poses it started from and at those it returned.

Exits non-zero when a command fails; ``summary.json`` is written first
when the failure is the final pose BA's, and the evaluation runs whenever
``ckpt_final`` was written.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch

from ..ops import render as render_mod
from ..utils.profiling import device_label
from . import eval_ckpt, make_fullres_dataset, run_config34

FRAMES, TRAIN_FRAMES, GLOBAL_ITERS = 60, 46, 30000


def progressive_iterations(cfg, n_frames: int, sample_rate: int = 8) -> int:
    """Optimizer iterations of ``Trainer.progressive_run`` on a sequence
    loaded at ``sample_rate`` (test frames sample_rate // 2 ::
    sample_rate): tracking on every frame but 0, first_frame_mapping_iters
    on frame 0 and mapping_iters on every other train frame."""
    test = set(range(sample_rate // 2, n_frames, sample_rate))
    mapped = [t for t in range(1, n_frames) if t not in test]
    return (cfg.tracking_iters * (n_frames - 1) + cfg.first_frame_mapping_iters
            + cfg.mapping_iters * len(mapped))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--seed", type=int, default=7,
                    help="the recipe's seed (cli.make_fullres_dataset)")
    ap.add_argument("--pose_ba_every", type=int, default=0,
                    help="mid-global pose-BA cadence passed to "
                         "cli.run_config34 (0 = off, Arm A; 2500 = "
                         "cfg34_r5b's arm)")
    ap.add_argument("--grad_sum", default="direct",
                    choices=("direct", "prefix"),
                    help="the backward's per-Gaussian reduction (direct = "
                         "Arm A; prefix = the JAX package's default, Arm C)")
    return ap.parse_args(argv)


def run_config34_argv(args, data: Path, out: Path) -> list[str]:
    """The ``cli.run_config34`` command line of the run: Arm A's, plus
    ``--pose_ba_every`` and ``--grad_sum`` when they are set."""
    argv = ["--data", str(data), "--out", str(out),
            "--frames", str(TRAIN_FRAMES), "--depth_prior", "metric",
            "--rebin_every", "4", "--global_iters", str(GLOBAL_ITERS),
            "--global_chunk", "250", "--tracking_gn_iters", "8",
            "--save_ckpt", "--pose_ba_final", "1", "--budget_s", "2700",
            "--device", "cuda"]
    if args.pose_ba_every:
        argv += ["--pose_ba_every", str(args.pose_ba_every)]
    if args.grad_sum != "direct":
        argv += ["--grad_sum", args.grad_sum]
    return argv


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the full-scale run is for the "
                           "card")
    smi = device_label(torch.device("cuda"))
    results = Path(args.results)
    results.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="fullscale_"))
    data, out = work / "data", work / "run"
    argv34 = run_config34_argv(args, data, out)

    # the largest instance count of any render, kept on the device
    peak_inst = {"n": None}
    real_rasterize = render_mod.rasterize

    def rasterize_spy(*a, **kw):
        res = real_rasterize(*a, **kw)
        n = res["num_instances"].to(torch.int64)
        peak_inst["n"] = n if peak_inst["n"] is None else torch.maximum(
            peak_inst["n"], n)
        return res

    log_path = results / "train.log"
    argv_data = ["--out", str(data), "--frames", str(FRAMES), "--seed",
                 str(args.seed), "--device", "cuda"]
    argv_eval = ["--ckpt", str(out / "ckpt_final"), "--data", str(data),
                 "--frames", str(TRAIN_FRAMES), "--device", "cuda"]
    if args.grad_sum != "direct":
        argv_eval += ["--grad_sum", args.grad_sum]
    info = {"nvidia_smi": smi, "grad_sum": args.grad_sum,
            "torch": torch.__version__,
            "cuda": torch.version.cuda, "make_fullres_dataset_argv":
            argv_data[2:], "run_config34_argv": argv34,
            "eval_ckpt_argv": argv_eval}
    error = None
    evaluation = None
    t0 = time.time()
    with open(log_path, "w", buffering=1) as log, \
            contextlib.redirect_stdout(log):
        print(smi, flush=True)
        info["dataset"] = make_fullres_dataset.main(argv_data)
        torch.cuda.reset_peak_memory_stats()
        render_mod.rasterize = rasterize_spy
        try:
            run_config34.main(argv34)
        except Exception:       # recorded below; the exit code says so
            error = traceback.format_exc()
            print(error, flush=True)
        finally:
            render_mod.rasterize = real_rasterize
        torch.cuda.synchronize()
        info["seconds_total"] = time.time() - t0
        info["peak_memory_allocated_bytes"] = (
            torch.cuda.max_memory_allocated())
        if (out / "ckpt_final").exists():
            t1 = time.time()
            try:
                evaluation, _ = eval_ckpt.run(eval_ckpt.parse(argv_eval))
                print(json.dumps(evaluation), flush=True)
            except Exception:
                error = (error or "") + traceback.format_exc()
                print(error, flush=True)
            info["eval_seconds"] = time.time() - t1
    if peak_inst["n"] is not None:
        info["num_instances_max_training"] = int(peak_inst["n"])
    metrics = out / "metrics.jsonl"
    rows = ([json.loads(ln) for ln in metrics.read_text().splitlines()]
            if metrics.exists() else [])
    info["pose_ba_passes"] = [r for r in rows if r.get("stage") == "pose_ba"]
    lines = log_path.read_text().splitlines()
    info["warnings_logged"] = [ln for ln in lines if "WARNING" in ln]
    info["nonfinite_logged"] = [ln for ln in lines if "NONFINITE" in ln]
    if error is not None:
        info["error"] = error

    it = progressive_iterations(run_config34.TrainConfig(), TRAIN_FRAMES)
    for name in ("summary.json", "summary_ba.json"):
        path = out / name
        if not path.exists():
            continue
        s = json.loads(path.read_text())
        s.update(info, progressive_iterations=it,
                 progressive_iterations_per_s=it / max(s["progressive_s"],
                                                       1e-9),
                 global_iterations_per_s=s["global_iters_done"]
                 / max(s["global_s"], 1e-9))
        (results / name).write_text(json.dumps(s, indent=1) + "\n")
    for name in ("metrics.jsonl", "cameras.json"):
        if (out / name).exists():
            shutil.copy(out / name, results / name)
    if not (results / "summary.json").exists():
        (results / "summary.json").write_text(json.dumps(info, indent=1))
    if evaluation is not None:
        (results / "eval_ckpt.json").write_text(json.dumps(evaluation)
                                                + "\n")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({k: info[k] for k in ("nvidia_smi", "seconds_total")}
                     | {"error": error is not None}), flush=True)
    return 1 if error is not None else 0


if __name__ == "__main__":
    raise SystemExit(main())
