"""The numbers that decide ``correct``: the program's checked training steps
against the plain reference's, from the same state and inputs, for each
checked episode under its prefix (the global stage: ``f0_`` for frame 0's
first steps from the reference's own initial map, none for the steps at
the window's iteration from the program's state):

  loss_gap    the widest relative gap of a step's loss;
  grad1_gap   the first step's gradient as the optimizer gets it: by the
              worst leaf, the gap between the program's norm and the
              reference's, over the reference's norm of that leaf or of the
              median leaf, whichever is larger;
  change_gap  the parameters' change over the checked steps, by the same
              measure; leaves whose reference gradient is under a
              thousandth of the median leaf's are left out (they move by
              Adam's round-off alone).

Each is held to its cell's limit (``perfbench/workloads/<cell>.json``).
"""

from __future__ import annotations

import math
import statistics


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keep)


def numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {prefix: readings of an episode}; the numbers of
    every episode of ``ref``, each under its prefix."""
    out = {}
    for p, r in ref.items():
        out.update({p + k: v for k, v in episode(prog[p], r).items()})
    return out


def episode(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"losses": [...], "grad1": {leaf: norm},
    "change": {leaf: norm}}."""
    loss = math.inf if len(prog["losses"]) != len(ref["losses"]) else max(
        abs(a - b) / max(abs(b), 1e-30)
        for a, b in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad1"].values())
    moving = [k for k, v in ref["grad1"].items() if v >= 1e-3 * g_med]
    return {"loss_gap": loss,
            "grad1_gap": _leaf_gap(prog["grad1"], ref["grad1"],
                                   ref["grad1"]),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moving)}


def judge(nums: dict, limits: dict) -> bool:
    """Every number present, finite and within its limit."""
    return all(k in nums and math.isfinite(nums[k]) and nums[k] <= lim
               for k, lim in limits.items())
