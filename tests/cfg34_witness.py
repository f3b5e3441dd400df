#!/usr/bin/env python3
"""CPU witness for the full-scale quality gap between the port and the JAX
package: both packages' ``run_config34`` on one recipe, side by side.

    python tests/cfg34_witness.py --work <dir> [--cut global|tracking]
        [--threads 4]

The recipe is made once by the port's ``cli.make_fullres_dataset --device
cpu`` at 128x160 (20,000 Gaussians, seed 7; 2,048 initial map Gaussians
against the full size's 131,072). Its frames are within 1 LSB of the JAX
recipe's (tests/test_torch_fullres.py). Then ``scripts/run_config34.py``
(JAX on the CPU, its Pallas kernels in interpret mode, f32) and ``python
-m freesurgs_tpu_torch.cli.run_config34 --device cpu`` train on it at
cfg34_r5c's settings (``--depth_prior metric --rebin_every 4
--tracking_gn_iters 8``), in two processes at once with ``--threads``
threads each. ``--cut global``: 12 frames made and trained, 1,000 global
iterations in chunks of 250 (~50 min with 4 threads). ``--cut
tracking``: Arm A's frames, 60 made and 46 trained, and no global stage:
the progressive stage, where the poses are fixed, at its full length
(JAX ~30 min; the port's plain CPU compositing slows with the map, past
2 h). Each run writes its metrics.jsonl as it goes, so a stopped run
still holds the frames it finished.
Prints, and writes to ``<work>/witness.json``, both summaries side by side
with each run's per-frame progressive rows and global-stage rows (loss,
active Gaussians) from its metrics.jsonl; each run's console log is
``<work>/{jax,torch}.log``.

Not collected by pytest (its name does not start with ``test_``): it takes
minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SUMMARY_KEYS = ("psnr", "ssim", "lpips", "psnr_train", "ate", "rpe_trans",
                "rpe_rot_deg", "init_active", "final_active",
                "final_capacity", "progressive_s", "global_s",
                "global_iters_done")
ROW_KEYS = ("frame", "iter", "loss", "rgb", "rgb_loss", "flow_loss",
            "gn_resid_px", "num_active", "inst")
HW, N_GAUSSIANS, GLOBAL_CHUNK = (128, 160), 20000, 250
# frames made, frames trained, global iterations
CUTS = {"global": (12, 12, 1000), "tracking": (60, 46, 0)}


def rows(path: Path, stage: str) -> list[dict]:
    out = []
    for line in path.read_text().splitlines():
        r = json.loads(line)
        if r.get("stage") == stage:
            out.append({k: r[k] for k in ROW_KEYS if k in r})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", required=True)
    ap.add_argument("--cut", choices=sorted(CUTS), default="global")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    made, frames, global_iters = CUTS[args.cut]

    work = Path(args.work).resolve()
    data = work / "data"
    threads = str(args.threads)
    env = dict(os.environ, OMP_NUM_THREADS=threads, JAX_PLATFORMS="cpu",
               FSTPU_COMPILE_CACHE="",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         f"intra_op_parallelism_threads={threads}")
    t0 = time.time()
    subprocess.run(
        [sys.executable, "-m", "freesurgs_tpu_torch.cli.make_fullres_dataset",
         "--out", str(data), "--frames", str(made), "--n",
         str(N_GAUSSIANS), "--hw", *map(str, HW), "--device", "cpu"],
        cwd=REPO, env=env, check=True)
    common = ["--data", str(data), "--frames", str(frames),
              "--depth_prior", "metric", "--rebin_every", "4",
              "--global_iters", str(global_iters), "--global_chunk",
              str(GLOBAL_CHUNK), "--tracking_gn_iters", "8",
              "--checkpoint_every", "0", "--budget_s", "1e9"]
    cmds = {"jax": [sys.executable, "scripts/run_config34.py",
                    "--out", str(work / "jax"), *common],
            "torch": [sys.executable, "-m",
                      "freesurgs_tpu_torch.cli.run_config34",
                      "--out", str(work / "torch"), *common,
                      "--device", "cpu"]}
    procs = {}
    for name, cmd in cmds.items():
        with open(work / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, cwd=REPO, env=env,
                                           stdout=log,
                                           stderr=subprocess.STDOUT)
    codes = {name: p.wait() for name, p in procs.items()}
    res = {"cut": args.cut, "threads": args.threads, "exit_codes": codes,
           "seconds": time.time() - t0}
    for name in cmds:
        out = work / name
        if codes[name] != 0 or not (out / "summary.json").exists():
            continue
        s = json.loads((out / "summary.json").read_text())
        res[name] = {"summary": {k: s[k] for k in SUMMARY_KEYS if k in s},
                     "progressive": rows(out / "metrics.jsonl",
                                         "progressive"),
                     "global": rows(out / "metrics.jsonl", "global")}
    (work / "witness.json").write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({k: res[k]["summary"] for k in cmds if k in res}
                     | {"exit_codes": codes}))
    return 0 if all(c == 0 for c in codes.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
