"""The SfM-free job's progressive stage as a cell runs it: frames tracked
(constant-velocity init, Gauss-Newton flow-PnP, Adam on the pose against
the frozen map) and, on train frames, mapped two-view with a keyframe, as
``Trainer.progressive_run`` runs them.

Each frame goes through ``frame``: ``Trainer.progressive_frame(t)`` where
the program has one, otherwise the statements of ``progressive_run``'s
frame loop, in its order, on the Trainer's own methods (``track_frame``,
``render_frame``, ``_map_frame``, ``_maybe_grow``), with its history row
and its synchronization at the frame's end.

Set-up (timed as ``setup_s`` by the harness, from process start): kernels
built or loaded, the sequence made on the device from the seed
(``perfbench/scene.py``), the Trainer built as the configuration's command
line builds it (no pose is injected: the job tracks every pose from the
identity at frame 0) with the reference's own initial map put in place of
the one it made, frame 0 mapped as ``global_run.prepare`` maps it (its
first ``f0_steps`` checked), the ``warmup_frames``, and a copy of the
state. The window then makes whole passes over ``window_frames``, each
from that state, until ``seconds`` have passed: the same frames, the same
work however fast the program runs. A traced run traces one pass over
``trace_frames`` and runs the rest of the window's frames untraced.

After the window ``check_frame`` runs through the same path with its calls
recorded (``_FrameCapture``): the rigidity mask, the Gauss-Newton pose (the
first tracking gradient's input), the first tracking and two-view mapping
steps. The device's peak memory is read and the Trainer freed; ``check``
then has the reference (``reference/tracking.py``) work out the mask and
the Gauss-Newton solve, the tracking loss at the first steps' own poses
and its gradient at the first, and follow the mapping steps from the
program's map and poses; it replays Adam over the gradients of the whole
tracking loop from the Gauss-Newton pose, to the pose that the loop has to
leave in the pose table, and works out the last
mapping step's update from the moments that the frame kept, which the map
has to keep over the last step's inputs.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import types

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from perfbench import scene as scene_mod
from perfbench import trace as trace_mod
from perfbench.reference import mapping as M
from perfbench.reference import render as R
from perfbench.reference import tracking as T
from perfbench.stages import global_run as G

# planted faults of the reference put in the program's place
# (``python3 -m perfbench.control``): keyword arguments of ``check``
FAULTS = {"half_rows": {"drop_half_rows": True},
          "grad_half": {"fault": "grad_half"},
          "gn_skip": {"fault": "gn_skip"},
          "mask_drop": {"fault": "mask_drop"}}


def frame(trainer, t: int, i_train: set, t0: float):
    """Frame ``t`` of the progressive stage, as ``progressive_run`` runs it
    (without a viewer or panels)."""
    own = getattr(trainer, "progressive_frame", None)
    if own is not None:
        return own(t)
    self = trainer
    t_frame = time.time()
    self.cur_frame = t
    metrics: dict = {}
    overflow = []
    if t > 0:
        metrics = self.track_frame(t)
        if "overflow" in metrics:
            overflow.append(metrics["overflow"])
    if t not in i_train and self.cache_test_frames:
        out = self.render_frame(t)
        overflow.append(out["overflow"])
        with torch.no_grad():
            self.state.pred_depths[t] = out["render_dep"].to(torch.bfloat16)
            self.state.pred_colors[t] = torch.clamp(
                out["render"], 0.0, 1.0).to(torch.bfloat16)
    if t in i_train:
        self._update_sh_degree()
        n_it = (self.cfg.first_frame_mapping_iters if t == 0
                else self.cfg.mapping_iters)
        aux = self._map_frame(t, n_it, two_views=(t > 0))
        self.keyframes.append(t)
        metrics.update({k: aux[k] for k in ("loss", "num_active")})
        terms = aux["loss_terms"]
        if terms is not None:
            metrics["rgb"], metrics["pear"], metrics["lp"] = \
                terms[0], terms[1], terms[2]
        metrics["inst"] = aux["num_instances_max"]
        overflow.append(aux["overflow_max"])
        metrics["densify_events"] = aux["densify_events"]
        metrics["opacity_resets"] = aux["opacity_resets"]
        self._maybe_grow()
        self._report_nonfinite(aux, f"frame {t}")
    if overflow:
        metrics["overflow"] = torch.stack(
            [o.to(torch.float32) for o in overflow]).max()
        self._warn_overflow(float(metrics["overflow"]), f"frame {t}")
    if self.colors.is_cuda:
        torch.cuda.synchronize(self.colors.device)
    metrics["seconds"] = time.time() - t_frame
    row = {"stage": "progressive", "frame": t, **metrics}
    if t in i_train and aux["keyframe_views"] is not None:
        row["keyframe_views"] = aux["keyframe_views"].tolist()
    self.history.append(row)
    if t % 10 == 0:
        self.log_fn(f"[progressive {t}/{self.num_frames}] "
                    + " ".join(f"{k}={float(v):.4g}"
                               for k, v in metrics.items())
                    + f" ({time.time() - t0:.1f}s)")
        self._flush_history()


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


def snapshot(trainer) -> dict:
    """A copy of everything a frame changes."""
    st = trainer.state
    f = st.field
    gen = torch.Generator()
    gen.set_state(st.generator.get_state())
    state = dataclasses.replace(
        st, field=f.replace(**{k.name: _clone(getattr(f, k.name))
                               for k in dataclasses.fields(f)}),
        opt=dataclasses.replace(
            st.opt, mu={k: v.clone() for k, v in st.opt.mu.items()},
            nu={k: v.clone() for k, v in st.opt.nu.items()}),
        generator=gen, pred_depths=st.pred_depths.clone(),
        pred_colors=st.pred_colors.clone())
    p = trainer.poses
    return {"state": state,
            "poses": dataclasses.replace(p, quats=p.quats.clone(),
                                         trans=p.trans.clone()),
            "keyframes": list(trainer.keyframes),
            "sh_degree": trainer.active_sh_degree,
            "cur_frame": trainer.cur_frame,
            "history": len(trainer.history)}


def restore(trainer, snap: dict):
    """The Trainer back to ``snap`` (which stays as it is)."""
    copy = snapshot(types.SimpleNamespace(
        state=snap["state"], poses=snap["poses"], keyframes=snap["keyframes"],
        active_sh_degree=snap["sh_degree"], cur_frame=snap["cur_frame"],
        history=[]))
    trainer.state, trainer.poses = copy["state"], copy["poses"]
    trainer.keyframes = copy["keyframes"]
    trainer.active_sh_degree = snap["sh_degree"]
    trainer.cur_frame = snap["cur_frame"]
    del trainer.history[snap["history"]:]


def _frames(pair) -> list[int]:
    return list(range(pair[0], pair[1] + 1))


def _check_plan(cfg, traffic, i_train):
    """The checked frame comes right after the window and is a train frame;
    no opacity reset falls anywhere up to its end, and its checked mapping
    steps meet no densify."""
    win, c = _frames(traffic["window_frames"]), traffic["check_frame"]
    if c != win[-1] + 1 or c not in i_train or win[0] != \
            traffic["warmup_frames"][-1] + 1:
        raise RuntimeError("warm-up frames, window frames and the checked "
                           "train frame have to follow one another")
    before = cfg.first_frame_mapping_iters + cfg.mapping_iters * sum(
        1 for t in range(1, c) if t in i_train)
    if before + cfg.mapping_iters >= cfg.opacity_reset_interval:
        raise RuntimeError("an opacity reset falls before the checked frame "
                           "ends")
    for it in range(before + 1, before + traffic["check_mapping_steps"] + 1):
        if it % cfg.densify_interval == 0 and it < cfg.densify_until:
            raise RuntimeError(f"densify at {it} in the checked steps")


def _setup(spec: dict, traffic: dict, seed: int, device, log):
    """Set-up up to the window: (trainer, the train frames, the checked
    episodes' inputs so far, the sequence among them)."""
    from freesurgs_tpu_torch.core.camera import Camera
    from freesurgs_tpu_torch.ops import raster_cuda
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig

    dev = torch.device(device)
    t_run = time.time()

    def phase(name):
        log(f"[perfbench] {name}: {time.time() - t_run:.2f} s into the stage")

    if dev.type == "cuda":
        raster_cuda.build_kernels()
    phase("kernels ready")
    seq = scene_mod.make_sequence(seed, spec, dev)
    phase("sequence made")
    h, w = seq.height, seq.width
    pseq = types.SimpleNamespace(
        cam=Camera.from_K(seq.K, height=h, width=w), colors=seq.colors,
        monodeps=seq.monodeps, flows_fw=seq.flows_fw, i_train=seq.i_train,
        i_test=seq.i_test)
    cfg = TrainConfig(**spec["train"])
    i_train = set(int(i) for i in seq.i_train)
    _check_plan(cfg, traffic, i_train)
    trainer = Trainer(pseq, cfg, sh_degree_max=spec["sh_degree"],
                      global_chunk=spec["global_chunk"],
                      init_mask_frac=spec["init_mask_frac"], seed=seed,
                      log_fn=log, validation_every=0,
                      pose_init=spec["pose_init"],
                      cache_test_frames=spec["cache_test_frames"],
                      device=dev)
    init = M.initial_map(seq, spec["init_mask_frac"], seed,
                         spec["sh_degree"])
    if init["means"].shape[0] != spec["map_gaussians"]:
        raise RuntimeError(f"the map holds {init['means'].shape[0]} "
                           f"Gaussians, the configuration states "
                           f"{spec['map_gaussians']}")
    G._inject(trainer, init)
    phase("trainer built, the reference's initial map in place")

    n_f0 = traffic["f0_steps"]
    if n_f0 % cfg.rebin_every:
        raise RuntimeError("f0_steps has to be a multiple of rebin_every, "
                           "so that the split call rebins as one call does")
    trainer._update_sh_degree()
    f0_s0, f0_prog, f0_gen = G._steps(
        trainer, lambda: trainer._map_frame(0, n_f0, two_views=False), n_f0)
    trainer._map_frame(0, cfg.first_frame_mapping_iters - n_f0,
                       two_views=False)
    trainer.keyframes.append(0)
    trainer._maybe_grow()
    phase("frame 0 mapped")
    t0 = time.time()
    for t in traffic["warmup_frames"]:
        frame(trainer, t, i_train, t0)
    phase("warm-up frames run")
    n = init["means"].shape[0]
    inputs = {"episodes": {"f0_": {
        "state": {"params": {k: v.cpu() for k, v in init.items()},
                  "active": torch.ones(n, dtype=torch.bool), "mu": None,
                  "nu": None, "count": f0_s0["count"],
                  "iteration": f0_s0["iteration"],
                  "sh_degree": f0_s0["sh_degree"]},
        "schedule": G._schedule([0] * n_f0, cfg, f0_gen, h, w, dev)}},
        "seq": seq, "cam": seq.cam, "cfg": spec["train"], "device": dev,
        "program": {"f0_": f0_prog}}
    return trainer, i_train, inputs


class _FrameCapture(TorchFunctionMode):
    """Records the gradient calls of a frame (the step's own values;
    nothing is changed): of the first ``n + 1`` tracking and mapping calls
    each loss and the first call's gradients; the inputs (the pose) of the
    first ``n + 1`` tracking calls and the gradients of all; the inputs of
    mapping calls ``n + 1`` and ``last + 1``."""

    def __init__(self, n: int, last: int = -1):
        super().__init__()
        self.n, self.last = n, last
        self.calls = {"track": [], "map": []}

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.autograd.grad:
            loss, inputs = args[0], args[1]
            if isinstance(loss, (tuple, list)):
                loss = loss[0]
            track = len(inputs) == 2
            calls = self.calls["track" if track else "map"]
            k = len(calls)
            calls.append({
                "loss": float(loss.detach()) if k <= self.n or track
                else None,
                "grads": [g.detach().cpu() for g in out]
                if k == 0 or track else None,
                "inputs": [x.detach().cpu() for x in inputs]
                if (k <= self.n if track else k in (self.n, self.last))
                else None})
        return out


def _finite(g):
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def checked_frame(trainer, traffic: dict, i_train: set, inputs: dict):
    """Run the checked frame with its calls recorded; add its readings and
    the reference's inputs to ``inputs``."""
    from freesurgs_tpu_torch.models.gaussians import PARAM_NAMES
    c = traffic["check_frame"]
    n = traffic["check_tracking_steps"]
    if traffic["check_mapping_steps"] != n:
        raise RuntimeError("the checked frame records as many tracking as "
                           "mapping steps")
    st = trainer.state
    gen = torch.Generator()
    gen.set_state(st.generator.get_state())
    s0 = {"params": {k: v.detach().cpu() for k, v in
                     st.field.param_dict().items()},
          "mu": {k: v.cpu() for k, v in st.opt.mu.items()},
          "nu": {k: v.cpu() for k, v in st.opt.nu.items()},
          "active": st.field.active.cpu(), "count": st.opt.count,
          "iteration": st.iteration}
    poses0 = trainer.poses
    keyframes = list(trainer.keyframes)
    prev_depth = st.pred_depths[c - 1].clone()
    masks = []
    real_mask = trainer._rigid_mask

    def record_mask(t):
        m = real_mask(t)
        masks.append(m.detach().cpu())
        return m

    trainer._rigid_mask = record_mask
    try:
        with _FrameCapture(n, trainer.cfg.mapping_iters - 1) as cap:
            frame(trainer, c, i_train, time.time())
    finally:
        del trainer._rigid_mask
    track, mapped = cap.calls["track"], cap.calls["map"]
    if len(masks) != 1 or len(track) != trainer.cfg.tracking_iters or \
            len(mapped) != trainer.cfg.mapping_iters:
        raise RuntimeError(f"recorded {len(masks)} masks, {len(track)} "
                           f"tracking and {len(mapped)} mapping calls")
    q1, t1 = track[0]["inputs"]
    prog = {
        "gn_": {"pose": {"R": R.quat_rotmat(q1), "t": t1}},
        "tr_": {"losses": [s["loss"] for s in track[:n]],
                "grad1": G._leaf_norms({"q": _finite(track[0]["grads"][0]),
                                        "t": _finite(track[0]["grads"][1])}),
                "pose": {"R": R.quat_rotmat(trainer.poses.quats[c].detach()
                                            .cpu()),
                         "t": trainer.poses.trans[c].detach().cpu()}},
        "": {"losses": [s["loss"] for s in mapped[:n]],
             "grad1": G._leaf_norms({k: _finite(g) for k, g in zip(
                 PARAM_NAMES, mapped[0]["grads"])}),
             "change": G._leaf_norms({k: v - s0["params"][k] for k, v in zip(
                 PARAM_NAMES, mapped[n]["inputs"])}),
             "mask": masks[0] > 0,
             "kept": _kept(trainer.state, mapped[-1]["inputs"], PARAM_NAMES)}}
    inputs["program"].update(prog)
    kept = trainer.state
    s0["sh_degree"] = trainer.active_sh_degree
    inputs["frame"] = {
        "t": c, "state": s0, "generator": gen, "keyframes": keyframes,
        "mapping_iters": trainer.cfg.mapping_iters,
        "rebin_every": trainer.cfg.rebin_every,
        "keyframe_policy": trainer.cfg.keyframe_policy,
        "poses_before": {"q": poses0.quats.detach().cpu(),
                         "t": poses0.trans.detach().cpu()},
        "poses_after": {"q": trainer.poses.quats.detach().cpu(),
                        "t": trainer.poses.trans.detach().cpu()},
        "gn_start": {"q": q1, "t": t1},
        "track_poses": [s["inputs"] for s in track[:n]],
        "track_grads": [s["grads"] for s in track],
        "prev_depth": prev_depth.cpu(), "steps": n,
        "kept": {"mu": {k: v.cpu() for k, v in kept.opt.mu.items()},
                 "nu": {k: v.cpu() for k, v in kept.opt.nu.items()},
                 "count": kept.opt.count, "iteration": kept.iteration,
                 "slots": mapped[-1]["inputs"][0].shape[0]}}


def _kept(state, last_inputs, names) -> dict:
    """By leaf, the norm of what the map kept after the frame less the last
    mapping step's inputs: the last step's update, as the frame keeps it."""
    n = last_inputs[0].shape[0]
    return G._leaf_norms({k: getattr(state.field, k).detach()[:n].cpu() - x
                          for k, x in zip(names, last_inputs)})


def prepare(spec: dict, traffic: dict, seed: int, device, log):
    """Set-up, the window's frames once (untimed), and the checked frame:
    (trainer, the checked episodes' inputs with the program's readings
    under "program")."""
    trainer, i_train, inputs = _setup(spec, traffic, seed, device, log)
    t0 = time.time()
    for t in _frames(traffic["window_frames"]):
        frame(trainer, t, i_train, t0)
    checked_frame(trainer, traffic, i_train, inputs)
    return trainer, inputs


def _failed(rows, poses) -> int:
    """Frames of a pass whose losses or pose are not finite."""
    bad = 0
    for r in rows:
        vals = [float(r[k]) for k in ("loss", "rgb_loss", "flow_loss")
                if k in r]
        t = r["frame"]
        vals += poses.quats[t].tolist() + poses.trans[t].tolist()
        bad += not all(np.isfinite(vals))
    return bad


def run(spec: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, log) -> dict:
    """One run: set-up, the window (whole passes over the window's frames
    for ``seconds``; traced, one pass over ``trace_frames``), the checked
    frame, the program freed, and what the harness reads."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    trainer, i_train, inputs = _setup(spec, traffic, seed, device, log)
    snap = snapshot(trainer)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_end = time.time()

    frames = _frames(traffic["trace_frames" if trace else "window_frames"])
    prof = trace_mod.profile(cuda) if trace else None
    passes, walls = [], []
    if prof is not None:
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
    del snap
    n_frames = len(frames) * len(passes)
    failed = sum(_failed(rows, poses) for rows, poses in passes)
    log(f"[perfbench] window closed: {len(passes)} passes of {len(frames)} "
        f"frames in {t1 - t0:.2f} s; pass ends at "
        + " ".join(f"{w - t0:.2f}" for w in walls) + " s")
    for t in _frames(traffic["window_frames"]):
        if t > frames[-1]:
            frame(trainer, t, i_train, time.time())
    checked_frame(trainer, traffic, i_train, inputs)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del trainer, passes
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out = {"setup_end": setup_end, "attempted": n_frames, "failed": failed,
           "memory_peak_bytes": peak, "window_s": t1 - t0,
           "end_to_end": {"progressive_s_per_frame": (t1 - t0) / n_frames},
           "check_inputs": inputs}
    if trace:
        out["trace"] = trace_mod.reduce(prof, n_frames)
    return out


def _schedule(fr: dict, h: int, w: int, dev) -> list:
    """The checked two-view steps as the program draws them from its
    generator: the keyframe positions (sorted up front where the layout is
    carried, one a step otherwise), then each step's keyframe-view boxes
    and current-view boxes; each view rebins at the first step, at every
    ``rebin_every``-th and, the keyframe view, at a new keyframe."""
    if fr["keyframe_policy"] != "uniform":
        raise NotImplementedError("the reference draws uniform keyframes")
    gen = torch.Generator()
    gen.set_state(fr["generator"].get_state())
    kf, every, n_it = fr["keyframes"] or [0], fr["rebin_every"], \
        fr["mapping_iters"]
    carry = every > 1
    if carry:
        pos = torch.sort(torch.randint(0, len(kf), (n_it,),
                                       generator=gen)).values.tolist()
    out, prev = [], None
    for k in range(fr["steps"]):
        p = pos[k] if carry else int(torch.randint(0, len(kf), (),
                                                   generator=gen))
        kf_boxes = M.box_corners(h, w, gen, dev)
        cur_boxes = M.box_corners(h, w, gen, dev)
        period = carry and k % every == 0
        out.append(((fr["t"], not carry or k == 0 or period, cur_boxes),
                    (kf[p], not carry or k == 0 or p != prev or period,
                     kf_boxes)))
        prev = p
    return out


def check(inputs: dict, mode: str = "fp32", drop_half_rows: bool = False,
          fault: str | None = None) -> dict:
    """The reference's readings of each checked episode, by prefix, to put
    beside the program's (or, for a control or a planted fault, another
    run of the reference's). ``fault``: "grad_half" (the pose gradient
    halved), "gn_skip" (no Gauss-Newton step), "mask_drop" (no rigidity
    mask)."""
    dev = inputs["device"]
    seq, cam, cfg = inputs["seq"], inputs["cam"], inputs["cfg"]
    out = G.check({k: inputs[k] for k in ("episodes", "seq", "cam", "cfg",
                                          "device")}, mode, drop_half_rows)
    fr = inputs["frame"]
    c = fr["t"]

    def pose(which, t):
        p = fr[which]
        return p["q"][t].to(dev), p["t"][t].to(dev)

    q16, t16 = pose("poses_before", c - 2)
    q17, t17 = pose("poses_before", c - 1)
    w2c16, w2c17 = T.w2c(q16, t16), T.w2c(q17, t17)
    prev_depth = fr["prev_depth"].to(dev)
    with M.precision(mode):
        mask = T.rigidity_mask(w2c16, w2c17, seq.flows_fw[c - 2], cam)
        if fault == "mask_drop":
            mask = torch.ones_like(mask)
        qi, ti = T.const_velocity(q17, t17, q16, t16)
        init = {"R": R.quat_rotmat(qi), "t": ti}
        if fault == "gn_skip":
            Rg, tg = init["R"], ti
        else:
            Rg, tg = T.gauss_newton(
                qi, ti, prev_depth, w2c17, seq.flows_fw[c - 1], cam, mask,
                iters=cfg["tracking_gn_iters"],
                huber_px=cfg.get("tracking_gn_huber_px", 2.0))
    out["gn_"] = {"pose": {"R": Rg.cpu(), "t": tg.cpu()},
                  "init": {k: v.cpu() for k, v in init.items()}}

    s0 = fr["state"]
    params = {k: v.to(dev) for k, v in s0["params"].items()}
    active = s0["active"].to(dev)
    tr = T.track_at(
        params, active, [(q.to(dev), t.to(dev)) for q, t in fr["track_poses"]],
        cam, s0["sh_degree"], seq.colors[c], prev_depth, w2c17,
        seq.flows_fw[c - 1], mask, cfg, mode=mode,
        drop_half_rows=drop_half_rows,
        grad_scale=0.5 if fault == "grad_half" else 1.0)
    kept = T.replay_tracking(fr["gn_start"]["q"], fr["gn_start"]["t"],
                             fr["track_grads"], cfg["tracking_iters"])
    out["tr_"] = {"losses": tr["losses"],
                  "grad1": G._leaf_norms(tr["grad1"]),
                  "pose": {"R": R.quat_rotmat(kept["q"]), "t": kept["t"]},
                  "init": {"R": R.quat_rotmat(fr["gn_start"]["q"]),
                           "t": fr["gn_start"]["t"]}}

    after = fr["poses_after"]
    poses = {t: T.w2c(after["q"][t].to(dev), after["t"][t].to(dev))
             for t in set(fr["keyframes"]) | {c, 0}}
    state = dict(s0, params=params, active=active,
                 mu={k: v.to(dev) for k, v in s0["mu"].items()},
                 nu={k: v.to(dev) for k, v in s0["nu"].items()})
    mp = T.follow_two_view(state, _schedule(fr, seq.height, seq.width, dev),
                           seq, poses, cam, cfg, mode=mode,
                           drop_half_rows=drop_half_rows)
    out[""] = {"losses": mp["losses"], "grad1": G._leaf_norms(mp["grad1"]),
               "change": G._leaf_norms({k: mp["params"][k] - params[k]
                                        for k in M.LEAVES}),
               "mask": mask.cpu(), "kept": _last_update(fr["kept"], cfg)}
    return out


def _last_update(kept: dict, cfg: dict) -> dict:
    """By leaf, the norm of the Adam update that the frame's last mapping
    step makes with the moments, step count and counter the frame kept."""
    lrs = M.learning_rates(cfg, kept["iteration"])
    c = kept["count"]
    bc1, bc2 = 1.0 - 0.9 ** c, 1.0 - 0.999 ** c
    n = kept["slots"]
    return G._leaf_norms({k: lrs[k] * (kept["mu"][k][:n] / bc1) / (
        torch.sqrt(kept["nu"][k][:n] / bc2) + 1e-15) for k in M.LEAVES})
