"""Stage driver of the global training stage: whole ``Trainer.global_run``
chunks of one-view mapping iterations, as ``cli.run_config34``'s
time-boxed loop runs them.

Set-up (timed as ``setup_s`` by the harness, from process start):
kernels built or loaded (cached by source hash inside the checkout), the
sequence made on the device from the seed (``perfbench/scene.py``), the
Trainer built as the configuration's command line builds it with the
ground-truth poses injected and the reference's own initial map
(``reference.mapping.initial_map``) put in place of the one it made, frame
0 mapped as the progressive stage maps it (its first ``f0_steps`` are
checked), the mapping counter and Adam's step count set to the traffic's
``start_iteration``, the checked steps run through the window's own inner
call (``mapping_chunk``, as ``global_run`` calls it) on the same Trainer,
and ``warmup_chunks`` chunks. The window then calls ``global_run(chunk)``
until ``seconds`` have passed (a traced run: ``trace_iterations`` in whole
chunks); nothing is added inside a chunk. Between chunks (host values
only) the counter and Adam's count go back to ``start_iteration``, so
every chunk maps iterations ``start_iteration + 1 .. + chunk`` however
fast the program runs: no opacity reset (every ``opacity_reset_interval``)
falls in the window, and each chunk's work stays the same.

After the window the device's peak memory is read and the Trainer freed;
in a traced run the trace is reduced and the work of every rendered frame
counted on the final map. ``check`` then has the reference follow both
checked episodes: frame 0's first steps from its own initial map, and the
checked steps at ``start_iteration`` from the state they started from.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import os
import time
import types

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from perfbench import scene as scene_mod
from perfbench import trace as trace_mod
from perfbench.reference import mapping as ref
from perfbench.reference import render as R


class _StepCapture(TorchFunctionMode):
    """Records each ``torch.autograd.grad`` call of the mapping step: the
    loss it differentiates and the gradients it returns (the step's own
    outputs; nothing is changed)."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.autograd.grad:
            loss = args[0][0] if isinstance(args[0], (tuple, list)) \
                else args[0]
            self.steps.append((loss.detach().clone(),
                               [g.detach().clone() for g in out]))
        return out


def _leaf_norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def _rebin_schedule(frames, rebin_every):
    if rebin_every <= 1:
        return [True] * len(frames)
    return [k == 0 or f != frames[k - 1] or k % rebin_every == 0
            for k, f in enumerate(frames)]


def _check_frames(seed: int, i_train, pattern):
    """Distinct train frames for the pattern's slots, from the seed."""
    rng = np.random.default_rng([seed, 7])
    picks = rng.choice(np.asarray(i_train), size=max(pattern) + 1,
                       replace=False)
    return [int(picks[i]) for i in pattern]


def rewind(trainer, start: int):
    """The mapping counter and Adam's step count back to ``start`` (host
    values; the map and the moments stay as they are)."""
    st = trainer.state
    trainer.state = dataclasses.replace(
        st, iteration=start, opt=dataclasses.replace(st.opt, count=start))


def window(trainer, chunk: int, start: int, more) -> int:
    """Whole ``global_run(chunk)`` calls while ``more(chunks done)`` holds,
    each from iteration ``start``. Returns the number of chunks."""
    n = 0
    while more(n):
        rewind(trainer, start)
        trainer.global_run(chunk)
        n += 1
    return n


def _check_window_clear(cfg, start: int, chunk: int):
    """No densify and no opacity reset in iterations start+1 .. start+chunk
    (a chunk of the window, and the checked steps)."""
    nxt = (start // cfg.opacity_reset_interval + 1) * \
        cfg.opacity_reset_interval
    if start < cfg.densify_until or start + chunk >= nxt:
        raise RuntimeError(
            f"iterations {start + 1}..{start + chunk} reach densify (until "
            f"{cfg.densify_until}) or the opacity reset at {nxt}")


def _host_log(walls, cpus, gc_s) -> str:
    """Per chunk: wall seconds / this process's CPU seconds / seconds in
    Python's garbage collector."""
    return " ".join(f"{w1 - w0:.3f}/{c1 - c0:.3f}/{g:.3f}"
                    for w0, w1, c0, c1, g in zip(walls, walls[1:], cpus,
                                                 cpus[1:], gc_s))


def _steps(trainer, call, n_steps: int):
    """Run ``call`` (``n_steps`` mapping iterations of the program) with its
    gradient calls recorded. Returns (the start state's parameters, Adam
    moments and counts on the host; the program's readings; a copy of the
    box generator as it was before the steps)."""
    from freesurgs_tpu_torch.models.gaussians import PARAM_NAMES
    st = trainer.state
    s0 = {"params": {k: v.detach().cpu() for k, v in
                     st.field.param_dict().items()},
          "mu": {k: v.cpu() for k, v in st.opt.mu.items()},
          "nu": {k: v.cpu() for k, v in st.opt.nu.items()},
          "active": st.field.active.cpu(), "count": st.opt.count,
          "iteration": st.iteration,
          "sh_degree": trainer.active_sh_degree}
    gen = torch.Generator()
    gen.set_state(st.generator.get_state())
    with _StepCapture() as cap:
        call()
    if len(cap.steps) != n_steps:
        raise RuntimeError(f"{len(cap.steps)} gradient calls in "
                           f"{n_steps} checked steps")
    program = {
        "losses": [float(s[0]) for s in cap.steps],
        "grad1": _leaf_norms({k: torch.where(torch.isfinite(g), g,
                                             torch.zeros_like(g))
                              for k, g in zip(PARAM_NAMES, cap.steps[0][1])}),
        "change": _leaf_norms({k: v.detach().cpu() - s0["params"][k]
                               for k, v in
                               trainer.state.field.param_dict().items()})}
    return s0, program, gen


def _inject(trainer, init: dict):
    """Put ``init`` (n Gaussians) in the first n slots of the Trainer's map,
    in place of the map it made; the other slots stay empty."""
    field = trainer.state.field
    n = init["means"].shape[0]
    act = field.active
    if int(act.sum()) != n or not bool(act[:n].all()):
        raise RuntimeError(f"the program's map holds {int(act.sum())} "
                           f"Gaussians, the reference's {n}")
    new = {}
    for k, v in init.items():
        x = getattr(field, k).clone()
        x[:n] = v
        new[k] = x
    trainer.state = dataclasses.replace(trainer.state,
                                        field=field.replace(**new))


def prepare(spec: dict, traffic: dict, seed: int, device, log):
    """Set-up up to the window: returns (trainer, the checked episodes'
    inputs for the reference, with the program's readings under
    "program")."""
    from freesurgs_tpu_torch.cli.run_config34 import inject_gt_poses
    from freesurgs_tpu_torch.core.camera import Camera
    from freesurgs_tpu_torch.ops import raster_cuda
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig, mapping_chunk

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
        i_test=seq.i_test, gt_poses={"k0": seq.gt_w2c},
        boundaries=[0, seq.colors.shape[0]])
    cfg = TrainConfig(**spec["train"])
    start, chunk = traffic["start_iteration"], spec["global_chunk"]
    _check_window_clear(cfg, start, chunk)
    trainer = Trainer(pseq, cfg, sh_degree_max=spec["sh_degree"],
                      global_chunk=chunk,
                      init_mask_frac=spec["init_mask_frac"], seed=seed,
                      log_fn=log, validation_every=0, device=dev)
    inject_gt_poses(trainer, pseq)
    init = ref.initial_map(seq, spec["init_mask_frac"], seed,
                           spec["sh_degree"])
    if init["means"].shape[0] != spec["map_gaussians"]:
        raise RuntimeError(f"the map holds {init['means'].shape[0]} "
                           f"Gaussians, the configuration states "
                           f"{spec['map_gaussians']}")
    _inject(trainer, init)
    phase("trainer built, the reference's initial map in place")

    # frame 0, as the progressive stage maps it; its first steps checked
    n_f0 = traffic["f0_steps"]
    if n_f0 % cfg.rebin_every:
        raise RuntimeError("f0_steps has to be a multiple of rebin_every, "
                           "so that the split call rebins as one call does")
    trainer._update_sh_degree()
    f0_s0, f0_prog, f0_gen = _steps(
        trainer, lambda: trainer._map_frame(0, n_f0, two_views=False), n_f0)
    trainer._map_frame(0, cfg.first_frame_mapping_iters - n_f0,
                       two_views=False)
    trainer.keyframes.append(0)
    trainer._maybe_grow()
    phase("frame 0 mapped")

    # the checked steps, through the window's own inner call
    rewind(trainer, start)
    frames = _check_frames(seed, seq.i_train, traffic["check_frames"])
    trainer._update_sh_degree()
    with torch.no_grad():
        w2c_all = trainer.poses.all_w2c()

    def checked():
        trainer.state, _ = mapping_chunk(
            trainer.state, trainer.colors, trainer.monodeps, w2c_all,
            frames, [], trainer.cam, cfg, two_views=False,
            sh_degree=trainer.active_sh_degree, densify_enabled=True)

    s0, prog, gen = _steps(trainer, checked, len(frames))
    phase("checked steps run")
    n = init["means"].shape[0]
    episodes = {
        "f0_": {"state": {"params": {k: v.cpu() for k, v in init.items()},
                          "active": torch.ones(n, dtype=torch.bool),
                          "mu": None, "nu": None, "count": f0_s0["count"],
                          "iteration": f0_s0["iteration"],
                          "sh_degree": f0_s0["sh_degree"]},
                "schedule": _schedule([0] * n_f0, cfg, f0_gen, h, w, dev)},
        "": {"state": s0,
             "schedule": _schedule(frames, cfg, gen, h, w, dev)}}
    inputs = {"episodes": episodes, "seq": seq, "cam": seq.cam,
              "cfg": spec["train"], "device": dev,
              "program": {"f0_": f0_prog, "": prog}}
    return trainer, inputs


def _schedule(frames, cfg, gen, h, w, dev):
    return [(f, rb, ref.box_corners(h, w, gen, dev)) for f, rb in
            zip(frames, _rebin_schedule(frames, cfg.rebin_every))]


def run(spec: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, log) -> dict:
    """One run: set-up, the window (``seconds`` of whole chunks; traced,
    ``trace_iterations`` rounded up to whole chunks), the program freed,
    and what the harness reads."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    trainer, inputs = prepare(spec, traffic, seed, device, log)
    chunk, start = spec["global_chunk"], traffic["start_iteration"]
    window(trainer, chunk, start, lambda n: n < traffic["warmup_chunks"])
    if cuda:
        torch.cuda.synchronize(dev)
    setup_end = time.time()

    # the window
    draws = copy.deepcopy(trainer._global_rng)
    hist0 = len(trainer.history)
    prof = trace_mod.profile(cuda) if trace else None
    n_trace = -(-traffic["trace_iterations"] // chunk)
    walls, cpus, gc_s, gc_t = [], [], [0.0], []

    def on_gc(phase_, info):
        if phase_ == "start":
            gc_t.append(time.perf_counter())
        elif gc_t:
            gc_s[-1] += time.perf_counter() - gc_t.pop()

    def more(n):
        walls.append(time.perf_counter())
        cpus.append(sum(os.times()[:2]))
        gc_s.append(0.0)
        return n < n_trace if trace else time.perf_counter() - t0 < seconds

    if prof is not None:
        prof.__enter__()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        n_chunks = window(trainer, chunk, start, more)
    finally:
        gc.callbacks.remove(on_gc)
    if cuda:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    iters = n_chunks * chunk
    rows = [r for r in trainer.history[hist0:] if r.get("stage") == "global"]
    failed = sum(chunk for r in rows if not np.isfinite(r["loss"]))

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    final = None
    if trace:
        f = trainer.field
        final = {"params": {k: v.detach().clone()
                            for k, v in f.param_dict().items()},
                 "active": f.active.clone(),
                 "sh_degree": trainer.active_sh_degree}
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"[perfbench] window closed: {iters} iterations in {t1 - t0:.2f} s;"
        " chunks (wall s / process CPU s / gc s): "
        + _host_log(walls, cpus, gc_s[1:]))
    out = {"setup_end": setup_end, "attempted": iters, "failed": failed,
           "memory_peak_bytes": peak, "window_s": t1 - t0,
           "end_to_end": {"global_it_per_s": iters / (t1 - t0)},
           "check_inputs": inputs}
    if trace:
        out["trace"] = trace_mod.reduce(prof, iters)
        del prof
        seq = inputs["seq"]
        renders: dict[int, int] = {}
        for _ in range(n_chunks):
            ts = draws.choice(np.asarray(seq.i_train, np.int64), size=chunk)
            for t_ in ts.tolist():
                renders[t_] = renders.get(t_, 0) + 1
        out["work"] = {"per_frame": frame_work(final, seq, renders),
                       "renders": renders, "height": seq.height,
                       "width": seq.width,
                       "active": int(final["active"].sum()),
                       "iterations": iters,
                       "boxes": len(
                           inputs["episodes"][""]["schedule"][0][2][0])}
    return out


def frame_work(field: dict, seq, frames) -> dict:
    """The work counts (``perfbench/work/counts.py``) of a fresh render of
    each of ``frames`` on ``field``, by the reference's geometry."""
    per_frame = {}
    w2c = seq.w2c
    with torch.no_grad():
        for t_ in frames:
            p, lay, comp, _ = R.render(field["params"], field["active"],
                                       w2c[int(t_)], seq.cam,
                                       field["sh_degree"])
            used = torch.zeros(len(p["depth"]), dtype=torch.bool,
                               device=lay.gauss.device)
            used[lay.gauss] = True
            per_frame[int(t_)] = {"blended": comp["blended"],
                                  "stopped": comp["stopped"],
                                  "gaussians": int(used.sum())}
    return per_frame


def check(inputs: dict, mode: str = "fp32",
          drop_half_rows: bool = False) -> dict:
    """The reference's readings of each checked episode, by the episode's
    prefix of the compared numbers, to put beside the program's (or, for a
    control, another run of the reference's)."""
    dev = inputs["device"]
    out = {}
    for name, ep in inputs["episodes"].items():
        s0 = ep["state"]
        params = _to(s0["params"], dev)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        state = dict(s0, params=params,
                     mu=_to(s0["mu"], dev) if s0["mu"] else zeros,
                     nu=_to(s0["nu"], dev) if s0["nu"] else zeros,
                     active=s0["active"].to(dev))
        r = ref.follow(state, ep["schedule"], inputs["seq"], inputs["cam"],
                       inputs["cfg"], mode=mode,
                       drop_half_rows=drop_half_rows)
        out[name] = {"losses": r["losses"], "grad1": _leaf_norms(r["grad1"]),
                     "change": _leaf_norms({k: r["params"][k] - params[k]
                                            for k in ref.LEAVES})}
    return out


def _to(d: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in d.items()}
