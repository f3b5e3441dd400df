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

and, where an episode's readings carry them (the progressive stage):

  mask_gap    the share of pixels on which the program's boolean mask and
              the reference's differ;
  pose_gap    a solved pose against the reference's, each from the same
              init: the larger of the rotations' chordal distance over the
              init's from the reference, and of the translations' distance
              over the init's.
  kept_gap    what the state kept against what its last step has to
              leave, by the worst leaf as grad1_gap measures.

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
    "change": {leaf: norm}} (the change may be left out), and optionally
    "mask" (a boolean tensor),
    "pose" ({"R": (3, 3), "t": (3,)} tensors; ``ref`` also has "init") and
    "kept" ({leaf: norm})."""
    out = {}
    if "mask" in ref:
        out["mask_gap"] = float((prog["mask"] != ref["mask"]).double().mean())
    if "pose" in ref:
        out["pose_gap"] = _pose_gap(prog["pose"], ref["pose"], ref["init"])
    if "kept" in ref:
        out["kept_gap"] = _leaf_gap(prog["kept"], ref["kept"], ref["kept"])
    if "losses" not in ref:
        return out
    loss = math.inf if len(prog["losses"]) != len(ref["losses"]) else max(
        abs(a - b) / max(abs(b), 1e-30)
        for a, b in zip(prog["losses"], ref["losses"]))
    out.update(loss_gap=loss, grad1_gap=_leaf_gap(prog["grad1"],
                                                  ref["grad1"], ref["grad1"]))
    if "change" in ref:
        g_med = statistics.median(ref["grad1"].values())
        moving = [k for k, v in ref["grad1"].items() if v >= 1e-3 * g_med]
        out["change_gap"] = _leaf_gap(prog["change"], ref["change"], moving)
    return out


def _pose_gap(prog: dict, ref: dict, init: dict) -> float:
    def dist(a, b):
        return float((a.double() - b.double()).norm())
    return max(dist(prog["R"], ref["R"]) / max(dist(init["R"], ref["R"]),
                                                1e-30),
               dist(prog["t"], ref["t"]) / max(dist(init["t"], ref["t"]),
                                                1e-30))


def judge(nums: dict, limits: dict) -> bool:
    """Every number present, finite and within its limit."""
    return all(k in nums and math.isfinite(nums[k]) and nums[k] <= lim
               for k, lim in limits.items())
