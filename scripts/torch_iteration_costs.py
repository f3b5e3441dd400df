#!/usr/bin/env python3
"""Host syncs and wall ms per training iteration of a tree of the port.

    python3 scripts/torch_iteration_costs.py [--tree DIR] [--iters 8]

Imports ``freesurgs_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this checkout), builds chip_smoke.py's slice (the full-res synthetic scene,
131,072 initial Gaussians), runs its progressive stage, then measures, with
chip_smoke.py's ``iteration_costs``, the host syncs (torch's sync debug
mode) and the wall ms per one-view mapping and per tracking iteration,
binning every render and with the layout carried. Prints one JSON line.

To compare two trees, unpack the other one (``git archive``) into an
ignored directory and run the script on both in turns in one session on
the card (A, B, B, A): wall times follow the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    dev = torch.device("cuda")
    t0 = time.time()
    _, seq = cs.slice_sequence(dev)
    tr = Trainer(seq, TrainConfig(**cs.SLICE_CFG), log_fn=lambda s: None,
                 device=dev, validation_every=0, **cs.SLICE_TRAINER)
    tr.progressive_run()
    torch.cuda.synchronize()
    costs = cs.iteration_costs(tr, n=args.iters)
    print(json.dumps({"tree": str(tree), "iters": args.iters,
                      "seconds": time.time() - t0, **costs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
