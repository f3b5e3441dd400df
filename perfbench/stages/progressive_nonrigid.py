"""The SfM-free job's progressive stage on the non-rigid sequence, as a cell
runs it: frames initialized by RANSAC PnP (``pose_init="pnp"``), masked by
the epipolar rigidity mask where the tissue deforms and the highlight
moves, refined by Gauss-Newton flow-PnP and Adam on the pose, and, on train
frames, mapped two-view with a keyframe, as ``Trainer.progressive_run``
runs them.

Everything but the sequence, the checked PnP solve and the traced pass's
spans is ``progressive_run``'s, imported: each frame through ``frame``
(``Trainer.progressive_frame(t)`` where the program has one), the state's
copy and restore between passes, the checked frame's recorded calls. The
sequence is ``perfbench/scene_nonrigid.py``'s (set-up, timed as
``setup_s``).

A traced run records the program's spans (``utils/profiling.py span``)
over its traced pass and joins them with the device trace
(``perfbench/spans_tracking.py``), under ``trace["tracking_spans"]``, with
the deltas of the program's PnP counter (``models/pnp.py PNP``) under
``trace["pnp"]``; a program without them leaves both empty.

At the checked frame the call to ``models/pose.py pnp_pose_init`` is
recorded as the checked frame records the rigidity mask (the call passes
through unchanged): its inputs (frame t-1's depth cache, the flow t-1 -> t,
frame t-1's pose, the seed) and the pose it returned. ``check`` adds the
episode ``pnp_``: the program's PnP pose against the reference's
(``reference/pnp.py``) from the same inputs, each from the copied previous
pose (``pnp_pose_gap``). The reference's Gauss-Newton solve (``gn_``)
starts from the program's PnP pose; every other episode is
``progressive_run.check``'s.

After the checked frame (untimed; not a gate) the log gets the mask's
precision and recall against the ground-truth non-rigid pixels at the
checked frame, and PnP's and constant velocity's errors (their motion from
the tracked frame t-1 against the true motion) and the tracked pose's
error over frames 2 to the checked frame, from the final state.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import run as harness
from perfbench import scene_nonrigid
from perfbench import spans as spans_mod
from perfbench import spans_tracking
from perfbench import trace as trace_mod
from perfbench.reference import mapping as M
from perfbench.reference import pnp as PnP
from perfbench.reference import render as R
from perfbench.reference import tracking as T
from perfbench.stages import progressive_run as P

# planted faults of the reference put in the program's place
# (``python3 -m perfbench.control``): keyword arguments of ``check``
FAULTS = dict(P.FAULTS, pnp_skip={"fault": "pnp_skip"},
              pnp_no_ransac={"fault": "pnp_no_ransac"})

frame, snapshot, restore = P.frame, P.snapshot, P.restore


def _setup(spec: dict, traffic: dict, seed: int, device, log):
    """``progressive_run``'s set-up on the non-rigid sequence."""
    rigid = P.scene_mod
    P.scene_mod = scene_nonrigid
    try:
        return P._setup(spec, traffic, seed, device, log)
    finally:
        P.scene_mod = rigid


def checked_frame(trainer, traffic: dict, i_train: set, inputs: dict):
    """``progressive_run.checked_frame`` with the frame's PnP call
    recorded: its inputs under ``inputs["pnp"]``, the pose it returned
    under the program's ``pnp_``."""
    from freesurgs_tpu_torch.models import pose as posemod
    calls = []
    real = posemod.pnp_pose_init

    def record(poses, t, flow, depth, prev_w2c, cam, **kw):
        new = real(poses, t, flow, depth, prev_w2c, cam, **kw)
        calls.append({"t": t, "flow": flow.detach().cpu(),
                      "depth": depth.detach().cpu(),
                      "prev_w2c": prev_w2c.detach().cpu(), "kw": kw,
                      "q": new.quats[t].detach().cpu(),
                      "tr": new.trans[t].detach().cpu()})
        return new

    posemod.pnp_pose_init = record
    counted = _pnp_counter()
    try:
        P.checked_frame(trainer, traffic, i_train, inputs)
    finally:
        posemod.pnp_pose_init = real
    counted = {k: v - counted[k] for k, v in _pnp_counter().items()}
    c = traffic["check_frame"]
    if [k["t"] for k in calls] != [c]:
        raise RuntimeError(f"PnP ran on frames {[k['t'] for k in calls]} "
                           f"of the checked frame {c}")
    k = calls[0]
    inputs["pnp"] = {"flow": k["flow"], "depth": k["depth"],
                     "prev_w2c": k["prev_w2c"], "seed": k["kw"]["seed"],
                     "q": k["q"], "t": k["tr"],
                     "inliers": counted.get("inliers")}
    inputs["program"]["pnp_"] = {"pose": {"R": R.quat_rotmat(k["q"]),
                                          "t": k["tr"]}}


def prepare(spec: dict, traffic: dict, seed: int, device, log):
    """Set-up, the window's frames once (untimed), and the checked frame:
    (trainer, the checked episodes' inputs with the program's readings
    under "program")."""
    trainer, i_train, inputs = _setup(spec, traffic, seed, device, log)
    t0 = time.time()
    for t in P._frames(traffic["window_frames"]):
        frame(trainer, t, i_train, t0)
    checked_frame(trainer, traffic, i_train, inputs)
    return trainer, inputs


def _angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return math.degrees(math.acos(min(1.0, max(-1.0, c))))


def report(trainer, inputs: dict, last: int, log):
    """Log (not a gate) the rigidity mask against the ground truth at the
    checked frame, and the pose inits' errors against the true poses over
    frames 2..``last``, from the final state."""
    from freesurgs_tpu_torch.models import pose as posemod
    seq, c = inputs["seq"], inputs["frame"]["t"]
    kept = inputs["program"][""]["mask"]
    truth = seq.nonrigid_mask[c - 2].cpu()
    cut = ~kept
    hit = int((cut & truth).sum())
    log(f"[perfbench] rigidity mask, frame {c} (over frame {c - 2}'s "
        f"pixels): excluded {float(cut.double().mean()):.5f} of the "
        f"pixels, non-rigid {float(truth.double().mean()):.5f}; precision "
        f"{hit / max(int(cut.sum()), 1):.5f}, recall "
        f"{hit / max(int(truth.sum()), 1):.5f}")
    rows = []
    with torch.no_grad():
        for t in range(2, last + 1):
            pnp = posemod.pnp_pose_init(
                trainer.poses, t, trainer.flows_fw[t - 1],
                trainer.state.pred_depths[t - 1].to(torch.float32),
                trainer.poses.w2c(t - 1).detach(), trainer.cam,
                seed=trainer.seed + t)
            cv = posemod.const_velocity_init(trainer.poses, t)
            prev = trainer.poses.w2c(t - 1).double().cpu().numpy()
            true = seq.gt_w2c[t] @ np.linalg.inv(seq.gt_w2c[t - 1])
            row = [t]
            # an init's motion from the tracked frame t-1 against the true
            # motion t-1 -> t; the tracked pose against the true pose
            for w, want in ((pnp.w2c(t), true), (cv.w2c(t), true),
                            (trainer.poses.w2c(t), seq.gt_w2c[t])):
                w = w.double().cpu().numpy()
                if want is true:
                    w = w @ np.linalg.inv(prev)
                row += [float(np.linalg.norm(w[:3, 3] - want[:3, 3])),
                        _angle_deg(w[:3, :3], want[:3, :3])]
            rows.append(row)
    for r in rows:
        log("[perfbench] pose error frame %d: pnp init %.3e m %.4f deg, "
            "const_velocity init %.3e m %.4f deg (motion from frame t-1), "
            "tracked %.3e m %.4f deg" % tuple(r))
    a = np.array(rows)
    log("[perfbench] pose error medians over frames 2-%d: pnp init %.3e m "
        "%.4f deg, const_velocity init %.3e m %.4f deg, tracked %.3e m "
        "%.4f deg" % ((last,) + tuple(np.median(a[:, 1:], 0))))


def _stderr(msg):
    print(msg, file=sys.stderr, flush=True)


def _pnp_counter():
    from freesurgs_tpu_torch.models import pnp
    return dict(getattr(pnp, "PNP", {}))


def run(spec: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, log) -> dict:
    """One run: set-up, the window (whole passes over the window's frames
    for ``seconds``; traced, one pass over ``trace_frames`` with the spans
    recorded), the checked frame, the report, the program freed, and what
    the harness reads."""
    from freesurgs_tpu_torch.utils import profiling
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    trainer, i_train, inputs = _setup(spec, traffic, seed, device, log)
    snap = snapshot(trainer)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_end = time.time()

    frames = P._frames(traffic["trace_frames" if trace else "window_frames"])
    prof = trace_mod.profile(cuda) if trace else None
    passes, walls, spans = [], [], []
    pnp0 = _pnp_counter()
    if prof is not None:
        profiling.SPANS.start()
        prof.__enter__()
    t0 = time.perf_counter()
    while True:
        if passes:
            restore(trainer, snap)
        h0 = len(trainer.history)
        for t in frames:
            frame(trainer, t, i_train, time.time())
        passes.append((trainer.history[h0:], trainer.poses))
        walls.append(time.perf_counter())
        if trace or walls[-1] - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
        spans = profiling.SPANS.stop()
    pnp_calls = {k: v - pnp0.get(k, 0) for k, v in _pnp_counter().items()}
    threads, main_tid = profiling.SPANS.threads, profiling.SPANS.main_tid
    del snap
    n_frames = len(frames) * len(passes)
    failed = sum(P._failed(rows, poses) for rows, poses in passes)
    log(f"[perfbench] window closed: {len(passes)} passes of {len(frames)} "
        f"frames in {t1 - t0:.2f} s; pass ends at "
        + " ".join(f"{w - t0:.2f}" for w in walls) + " s")
    for t in P._frames(traffic["window_frames"]):
        if t > frames[-1]:
            frame(trainer, t, i_train, time.time())
    checked_frame(trainer, traffic, i_train, inputs)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    report(trainer, inputs, traffic["check_frame"], log)
    del trainer, passes
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out = {"setup_end": setup_end, "attempted": n_frames, "failed": failed,
           "memory_peak_bytes": peak, "window_s": t1 - t0,
           "end_to_end": {"progressive_s_per_frame": (t1 - t0) / n_frames},
           "check_inputs": inputs}
    if trace:
        import freesurgs_tpu_torch
        own = harness.program_kernels(
            Path(freesurgs_tpu_torch.__file__).resolve().parent.parent)
        out["trace"] = trace_mod.reduce(prof, n_frames)
        out["trace"]["tracking_spans"] = spans_tracking.join(
            spans_mod.events(prof), spans, threads, main_tid, t1 - t0,
            own) if spans else None
        out["trace"]["pnp"] = pnp_calls
        j = out["trace"]["tracking_spans"]
        log("[perfbench] tracking spans: " + str(spans_tracking.metrics(j))
            + f"; PnP counter over the traced pass: {pnp_calls}")
        if j:
            log("[perfbench] tracking join per traced frame: " + json.dumps(
                {k: {q: round(v / n_frames, 4) for q, v in p.items()}
                 for k, p in j["layers"].items()}))
    return out


def check(inputs: dict, mode: str = "fp32", drop_half_rows: bool = False,
          fault: str | None = None) -> dict:
    """``progressive_run.check``'s episodes with the Gauss-Newton solve
    started from the program's PnP pose, and the episode ``pnp_``. The
    faults of ``progressive_run`` and "pnp_skip" (constant velocity in
    place of PnP), "pnp_no_ransac" (one transform over all matches,
    refined over all). The reference's own readings (no fault, float32)
    log the two RANSAC winners' inlier counts (the program's from its PnP
    counter, where it has one): a tie within rounding may pick another
    winner, which the refined pose then shows."""
    dev = inputs["device"]
    seq, cam, cfg = inputs["seq"], inputs["cam"], inputs["cfg"]
    out = P.check(inputs, mode, drop_half_rows, fault)
    fr, pn = inputs["frame"], inputs["pnp"]
    c = fr["t"]
    prev_w2c = pn["prev_w2c"].to(dev)
    with M.precision(mode):
        if fault == "pnp_skip":
            before = fr["poses_before"]
            qi, ti = T.const_velocity(
                before["q"][c - 1].to(dev), before["t"][c - 1].to(dev),
                before["q"][c - 2].to(dev), before["t"][c - 2].to(dev))
            w2c = T.w2c(qi, ti).double()
            solved = {}
        else:
            solved = PnP.pose_init(prev_w2c, pn["flow"].to(dev),
                                   pn["depth"].to(dev), cam, pn["seed"],
                                   ransac=fault != "pnp_no_ransac")
            w2c = solved["w2c"]
        q0, t0 = pn["q"].to(dev), pn["t"].to(dev)
        mask = out[""]["mask"].to(dev)
        if fault == "gn_skip":
            Rg, tg = R.quat_rotmat(q0), t0
        else:
            Rg, tg = T.gauss_newton(
                q0, t0, fr["prev_depth"].to(dev), T.w2c(
                    fr["poses_before"]["q"][c - 1].to(dev),
                    fr["poses_before"]["t"][c - 1].to(dev)),
                seq.flows_fw[c - 1], cam, mask,
                iters=cfg["tracking_gn_iters"],
                huber_px=cfg.get("tracking_gn_huber_px", 2.0))
    if fault is None and mode == "fp32" and not drop_half_rows:
        _stderr(
            f"[perfbench] PnP at frame {c}: the program's winner "
            f"{pn.get('inliers')} inliers, the reference's "
            f"{solved['inliers']} (hypothesis {solved['best']}) of "
            f"{solved['matches']} matches")
    out["gn_"] = {"pose": {"R": Rg.cpu(), "t": tg.cpu()},
                  "init": {"R": R.quat_rotmat(q0).cpu(), "t": t0.cpu()}}
    out["pnp_"] = {"pose": {"R": w2c[:3, :3].cpu(), "t": w2c[:3, 3].cpu()},
                   "init": {"R": prev_w2c[:3, :3].cpu(),
                            "t": prev_w2c[:3, 3].cpu()},
                   "solve": {k: solved[k] for k in ("ok", "inliers", "best",
                                                    "matches")
                             if k in solved}}
    return out
