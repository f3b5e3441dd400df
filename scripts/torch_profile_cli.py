#!/usr/bin/env python3
"""Where the host time of the port's command line goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_cli.py [--top 12]

Writes chip_smoke.py's cli fixture (the slice's synthetic scene, 4 frames
at 1280x1024) into a temporary directory, then runs ``cli.train`` at the
cli phase's depth cut and ``cli.render --split all`` under cProfile, one
after the other, and prints one JSON line per command: its wall seconds,
the card's name and power limit, and the functions with the most
cumulative and the most own time (file:line:name, seconds, calls).
cProfile adds a cost to every Python call and none to work in native code
or on the card, so the shares are approximate. Exits 2 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import pstats
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def top(prof: cProfile.Profile, n: int, key: int) -> list[dict]:
    """The n functions with the largest stat ``key`` (2: own, 3:
    cumulative seconds)."""
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][key])[:n]
    return [{"fn": f"{Path(f).name}:{line}:{fn}", "cum_s": ct,
             "own_s": tt, "calls": nc}
            for (f, line, fn), (_, nc, tt, ct, _) in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_cli: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from freesurgs_tpu_torch.cli import render, train
    from freesurgs_tpu_torch.data.scared import save_synthetic_as_scared

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        data, out = Path(tmp) / "data", Path(tmp) / "run"
        scene, _ = cs.slice_sequence(torch.device("cuda", 0))
        save_synthetic_as_scared(scene, str(data))
        del scene
        base = cs.cli_argv(data, out)
        for name, fn, cmd in (
                ("train", train.main, base),
                ("render", render.main, base + [
                    "--run_start_checkpoint", str(out / "ckpt_final"),
                    "--split", "all"])):
            prof = cProfile.Profile()
            t = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                prof.enable()
                code = fn(cmd)
                torch.cuda.synchronize()
                prof.disable()
            print(json.dumps({
                "command": name, "exit": code, "seconds": time.time() - t,
                "device": smi, "by_cumulative": top(prof, args.top, 3),
                "by_own": top(prof, args.top, 2)}), flush=True)
            if code != 0:
                return code
    return 0


if __name__ == "__main__":
    sys.exit(main())
