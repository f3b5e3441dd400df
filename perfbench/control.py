"""Readings that set the limits deciding ``correct``, at a cell's own size.

  python3 -m perfbench.control --workload <cell> --seeds 11,12,13 \
      [--faults 3] [--out chiprun_out/control_<cell>.jsonl]

For each seed, in one process: the cell's set-up up to its checked steps
(no window), then the comparison's numbers (``perfbench/check.py``), of
every checked episode, of

  program    the program's checked steps against the reference: the
             lower readings;
  control    the reference put in the program's place and computed in TF32
             (the configuration states float32 with TF32 off);
  half_rows  the reference in the program's place with half of the batch
             left out: the photometric loss over the top half of the rows;
  unchanged  a step that returns its state unchanged (its change reads 1
             by the measure, so it needs no run; given for completeness);

and each further fault that the cell's stage module plants in the
reference put in the program's place (its ``FAULTS``: the name of each and
the keyword arguments of its ``check``; ``half_rows`` where it names none).

Each seed's line is printed as JSON and appended to ``--out``. Needs the
card unless a test passes ``device``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

from perfbench import check
from perfbench import run as harness


def readings(cell: str, seeds, *, faults: int | None = None,
             device: str = "cuda", root: Path = harness.ROOT,
             here: Path = harness.HERE, log=None):
    """Yield {seed, program, unchanged, control, <each fault>} per seed;
    the control and the faults on the first ``faults`` seeds only (all
    when None)."""
    faults = len(seeds) if faults is None else faults
    _, _, spec, traffic, _ = harness.load_cell(cell, root, here)
    stage = harness.load_stage(traffic, here)
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    for seed in seeds:
        trainer, inputs = stage.prepare(spec, traffic, seed, device, log)
        del trainer
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = stage.check(inputs)
        prog = inputs["program"]
        unchanged = {p: dict(r, change={k: 0.0 for k in r["change"]})
                     if "change" in r else r for p, r in prog.items()}
        out = {"seed": seed, "program": check.numbers(prog, ref),
               "unchanged": check.numbers(unchanged, ref)}
        if faults:
            faults -= 1
            out["control"] = check.numbers(stage.check(inputs, mode="tf32"),
                                           ref)
            for name, kw in getattr(stage, "FAULTS", {
                    "half_rows": {"drop_half_rows": True}}).items():
                out[name] = check.numbers(stage.check(inputs, **kw), ref)
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--faults", type=int, default=None,
                    help="read the control and the faults on this many of "
                    "the seeds (the first); all when not given")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control readings need the CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(args.workload, seeds, faults=args.faults):
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
