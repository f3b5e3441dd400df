"""Frozen counts of the operations and bytes a mapping iteration needs, and
the peaks they are set against.

The counts come from the inputs' geometry, whatever implements the work:
``blended`` is the number of (pixel, Gaussian) pairs inside the Gaussian's
alpha >= 1/255 footprint and in front of the pixel's stop, ``stopped`` the
number of pixels that stop (each evaluates one pair more), ``gaussians``
the Gaussians with at least one such pair, all counted by the plain
reference renderer (``reference/render.py``) for the render in question.
Each input byte is read once and each output byte written once; the
projection, SH, SSIM's separable blur and Adam are counted once, with no
recomputation. Float operations (add, multiply, compare-free min, exp,
log and rsqrt each count one) per unit:

forward compositing, per blended pair (29): dx, dy (2); the quadratic form
  -0.5 (a dx^2 + c dy^2) - b dx dy (9); exp (1); alpha = min(0.99, o e)
  (2); the next transmittance T (1 - alpha) (2); the weight alpha T (1);
  six channels accumulated, a multiply-add each (12);
  per stopping pair (16): all but the weight and the channels;
backward compositing, per blended pair (85): alpha again (14); T
  recovered (2); the channels' gradients (12); the running sums behind
  the pair and dL/dalpha over six channels (30, +1 for T); the
  background's share (3); opacity and G (3); the power's gradient (1);
  the conic's three entries (9); the mean's two (10);
  per stopping pair (16);
projection and SH per Gaussian (900): camera transform 18, quaternion 12
  and rotation 25, R S 9, covariance 30, EWA Jacobian and 2D covariance
  32, conic 8, pixel position 8, radius 8, sigmoid 3, exp of scales 3,
  view direction 8, SH degree 3 (16 basis terms 30, 48 multiply-adds 96),
  +0.5 and clamp 6: 296 forward, twice that backward;
losses per pixel (1540): L1 13; SSIM's five products 9, the 11-tap
  separable blur of 15 planes 660, the map 60, the mean 3, and the
  backward's blur 660 and map 120; global Pearson 14; the local Pearson
  boxes 14 per boxed pixel;
Adam per Gaussian parameter (12), 59 parameters a Gaussian at SH degree 3.

Bytes: compositing forward reads 10 floats a Gaussian and writes seven
planes (six channels and T_final); backward reads 10 floats a Gaussian,
the seven planes' cotangents and T_final, and writes 10 floats a
Gaussian.
"""

from __future__ import annotations

import json
from pathlib import Path

FWD_BLEND, FWD_STOP = 29, 16
BWD_BLEND, BWD_STOP = 85, 16
PROJECT_PER_GAUSSIAN = 900
LOSS_PER_PIXEL = 1540
LOCAL_PEARSON_PER_PIXEL = 14
BOX = 128
ADAM_PER_PARAM = 12
PARAMS_PER_GAUSSIAN = 59
F32 = 4


def k1(blended: int, stopped: int, gaussians: int, h: int, w: int):
    """(operations, bytes) of one render's forward compositing."""
    return (FWD_BLEND * blended + FWD_STOP * stopped,
            F32 * (10 * gaussians + 7 * h * w))


def k2(blended: int, stopped: int, gaussians: int, h: int, w: int):
    """(operations, bytes) of one render's backward compositing."""
    return (BWD_BLEND * blended + BWD_STOP * stopped,
            F32 * (20 * gaussians + 8 * h * w))


def mapping_step(blended: int, stopped: int, gaussians: int, active: int,
                 h: int, w: int, boxes: int) -> int:
    """Operations of one one-view mapping iteration: projection and SH of
    every Gaussian of the map, both compositing passes, the losses and
    their gradients, Adam."""
    return (k1(blended, stopped, gaussians, h, w)[0]
            + k2(blended, stopped, gaussians, h, w)[0]
            + PROJECT_PER_GAUSSIAN * active
            + LOSS_PER_PIXEL * h * w
            + LOCAL_PEARSON_PER_PIXEL * boxes * BOX * BOX
            + ADAM_PER_PARAM * PARAMS_PER_GAUSSIAN * active)


def peaks(device_kind: str) -> dict | None:
    """The card's published peaks ({"f32_flops", "bytes_per_s"}), None for
    a card the table does not hold."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    return table.get(device_kind)


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of operations over
    its float32 rate and bytes over its memory bandwidth."""
    return max(ops / peak["f32_flops"], nbytes / peak["bytes_per_s"])


def window_bound_s(work: dict, work_fn, peak: dict) -> float:
    """``bound_s`` of ``work_fn`` (``k1`` or ``k2``) summed over the
    renders of a window: ``work["renders"]`` {frame: renders},
    ``work["per_frame"]`` {frame: counts}."""
    total = 0.0
    for frame, n in work["renders"].items():
        f = work["per_frame"][frame]
        ops, nbytes = work_fn(f["blended"], f["stopped"], f["gaussians"],
                              work["height"], work["width"])
        total += n * bound_s(ops, nbytes, peak)
    return total
