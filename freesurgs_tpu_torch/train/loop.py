"""Training orchestrator (port of ``freesurgs_tpu/train/loop.py``).

 1. frame 0: initialize the Gaussian field from a masked back-projection of
    the monocular depth prior, then first_frame_mapping_iters mapping
    iterations on frame 0;
 2. frames t > 0: constant-velocity pose init -> tracking (GN flow-PnP init,
    then Adam, with the epipolar rigidity mask from frames t-2 / t-1) ->
    mapping on {random keyframe, t} for train frames; an unmapped test frame
    gets one render to keep the depth cache (the next frame's flow loss and
    GN solve) alive;
 3. global refinement: single-view mapping iterations over random train
    frames in chunks, with periodic checkpoints and validation, and with
    pose_ba_every > 0 a pose-BA pass over the train frames;
 4. validation: test-view PSNR / SSIM / LPIPS and sim(3)-aligned ATE / RPE.

With ``panel_fn`` the Trainer emits labelled panels (render | gt | depth |
monodep | flow) every ``panel_every`` frames of the progressive stage and
for every test view it validates; each panel is one more render.

``pose_init="pnp"`` initializes each frame t > 1 by RANSAC PnP on the
flow matches against frame t-1's cached depth (``models/pose.py``) instead
of the constant-velocity extrapolation. The viewer waits for a later slice
(ROADMAP.md, Queue 1 item 5) and raises when asked for. A render that drops
instances at the ``max_instances_cap`` cap is logged as a warning.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..convert import FIELD_KEYS
from ..core.camera import Camera
from ..eval.image_metrics import psnr, rgb_evaluation
from ..eval.pose_metrics import evaluate_subsequences
from ..eval.pose_refine import refine_poses_scan
from ..io.checkpoint import (load_checkpoint_meta, restore_checkpoint,
                             save_checkpoint)
from ..models import pose as posemod
from ..models.gaussians import GaussianField, from_rgbd, grow_capacity
from ..models.pose import PoseTable, identity_poses
from ..ops.render import render
from ..utils.image import add_label, colorize_depth, colorize_flow, hcat
from .optim import AdamState, adam_init
from .steps import MappingState, TrainConfig, check_supported, \
    mapping_chunk, tracking_loop


def create_random_mask(num_pixels: int, frac: float, seed: int = 0):
    """Keep ``frac`` of pixels (the reference's ``create_random_mask``)."""
    rng = np.random.default_rng(seed)
    k = int(frac * num_pixels)
    mask = np.zeros(num_pixels, bool)
    mask[rng.permutation(num_pixels)[:k]] = True
    return mask


@dataclasses.dataclass
class Trainer:
    """Holds the training state and drives the stages.

    ``seq`` is any object with the VideoSequence interface: colors
    (T, 3, H, W), flows_fw (T-1, 2, H, W), monodeps (T, H, W), cam,
    i_train / i_test (numpy arrays or tensors), and for the pose metrics of
    ``validation`` gt_poses ({name: (N, 4, 4)}) and boundaries.
    """

    seq: Any
    cfg: TrainConfig = TrainConfig()
    sh_degree_max: int = 3
    global_chunk: int = 100               # global iterations per chunk
    init_mask_frac: float = 0.1
    capacity: int | None = None
    seed: int = 6666
    log_fn: Any = print
    checkpoint_dir: str | None = None     # periodic global-stage saves
    checkpoint_every: int = 5000
    viewer: Any = None                    # ROADMAP Queue 1 item 5
    pose_init: str = "const_velocity"     # or "pnp"
    cache_test_frames: bool = True        # render an unmapped test frame
                                          # into the caches (False: leave
                                          # them empty, the reference's
                                          # behaviour)
    pose_ba_every: int = 0                # global-stage pose BA every N
                                          # global iterations (0 off): the
                                          # train poses but frame 0 are
                                          # refined against the frozen map
                                          # (eval/pose_refine.py)
    pose_ba_iters: int = 25
    pose_ba_lr: float = 1e-3
    metrics_logger: Any = None            # utils/logging.MetricsLogger:
                                          # history rows go to
                                          # metrics.jsonl at the log cadence
    panel_fn: Any = None                  # callable(name, hwc_img, step):
                                          # labelled comparison panels
    panel_every: int = 25                 # every N progressive frames
    validation_every: int = 5000          # mid-global test-view eval; 0 off
    max_capacity: int = 589_824
    device: Any = "cuda"

    def __post_init__(self):
        if self.pose_init not in ("const_velocity", "pnp"):
            raise ValueError(f"pose_init={self.pose_init!r}: "
                             "'const_velocity' or 'pnp'")
        if self.viewer is not None:
            raise NotImplementedError(
                "the viewer (viz/) is ROADMAP Queue 1 item 5")
        check_supported(self.cfg)
        dev = torch.device(self.device)
        seq = self.seq
        self.cam: Camera = seq.cam
        self.num_frames = int(seq.colors.shape[0])
        H, W = self.cam.height, self.cam.width

        def t(x):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.array(x))
            return x.to(device=dev, dtype=torch.float32)

        self.colors = t(seq.colors)
        self.monodeps = t(seq.monodeps)
        self.flows_fw = t(seq.flows_fw)
        self.K = t(self.cam.intrinsic_matrix())

        self.poses: PoseTable = identity_poses(self.num_frames, dev)
        self.active_sh_degree = 0

        # frame-0 depth cache = the monodepth prior; the caches are bf16
        # (the largest state tensors at full res; their consumers tolerate
        # ~3 decimal digits)
        pred_depths = torch.zeros(self.num_frames, H, W, dtype=torch.bfloat16,
                                  device=dev)
        pred_depths[0] = self.monodeps[0].to(torch.bfloat16)
        pred_colors = torch.zeros(self.num_frames, 3, H, W,
                                  dtype=torch.bfloat16, device=dev)

        mask = create_random_mask(H * W, self.init_mask_frac, self.seed)
        field = from_rgbd(self.colors[0], self.monodeps[0], self.cam,
                          torch.eye(4, device=dev), mask, self.sh_degree_max,
                          self.capacity)
        self.log_fn(f"init gaussians: {int(field.num_active)} "
                    f"(capacity {field.capacity}), scene_radius "
                    f"{float(field.scene_radius):.3f}")
        gen = torch.Generator()
        gen.manual_seed(self.seed)
        self.state = MappingState(
            field=field, opt=adam_init(field.param_dict()), iteration=0,
            generator=gen, pred_depths=pred_depths, pred_colors=pred_colors)
        self.keyframes: list[int] = []
        self.history: list[dict] = []
        self._history_flushed = 0
        # One continuing stream for the global stage's frame draws, so that
        # chunked global_run calls do not replay one sequence; the counter
        # of global iterations done carries across calls (and checkpoints)
        # so that the cadences see the total.
        self._global_rng = np.random.default_rng(self.seed + 1)
        self._global_done = 0

    @property
    def field(self) -> GaussianField:
        return self.state.field

    def _maybe_grow(self):
        """Grow capacity 2x (in 4096 quanta, up to max_capacity) when the
        slot pool is over 90% occupied."""
        n_act = int(self.field.num_active)
        cap = self.field.capacity
        if n_act <= 0.9 * cap:
            return
        if cap >= self.max_capacity:
            self.log_fn(f"WARNING: slot pool saturated at the max_capacity "
                        f"cap {cap} (active {n_act}): densify children are "
                        "being dropped")
            return
        new_cap = min(-(-int(cap * 2.0) // 4096) * 4096, self.max_capacity)
        self.log_fn(f"growing capacity {cap} -> {new_cap} (active {n_act})")
        self._resize_capacity(new_cap)

    def _resize_capacity(self, new_cap: int):
        """Re-shape the field and both Adam moments to ``new_cap`` slots:
        new slots are empty (zeros, identity quats), a shrink drops the
        tail."""
        cap = self.field.capacity
        if new_cap == cap:
            return
        if new_cap > cap:
            field = grow_capacity(self.field, new_cap)

            def fit(x):
                return torch.cat([x, x.new_zeros((new_cap - cap,)
                                                 + tuple(x.shape[1:]))])
        else:
            def fit(x):
                return x[:new_cap]
            f = self.field
            field = f.replace(**{k: fit(getattr(f, k)) for k in FIELD_KEYS
                                 if k != "scene_radius"})
        opt = self.state.opt
        opt = dataclasses.replace(
            opt, mu={k: fit(v) for k, v in opt.mu.items()},
            nu={k: fit(v) for k, v in opt.nu.items()})
        self.state = dataclasses.replace(self.state, field=field, opt=opt)

    def _update_sh_degree(self):
        want = min(self.state.iteration // self.cfg.sh_increase_interval,
                   self.sh_degree_max)
        if want > self.active_sh_degree:
            self.active_sh_degree = want
            self.log_fn(f"SH degree -> {want}")

    def _rigid_mask(self, t: int) -> torch.Tensor:
        if t <= 1:
            return torch.ones(self.cam.height, self.cam.width,
                              device=self.colors.device)
        _, sampson = posemod.epipolar_rigidity(
            self.poses, t - 2, t - 1, self.flows_fw[t - 2], self.cam, self.K)
        return posemod.adaptive_threshold_mask(sampson).to(torch.float32)

    def _map_frame(self, t: int, n_iters: int, two_views: bool):
        with torch.no_grad():
            w2c_all = self.poses.all_w2c()
        self.state, aux = mapping_chunk(
            self.state, self.colors, self.monodeps, w2c_all, [t] * n_iters,
            self.keyframes, self.cam, self.cfg, two_views=two_views,
            sh_degree=self.active_sh_degree, densify_enabled=True)
        return aux

    def _flush_history(self):
        """Stream the unflushed history rows to metrics.jsonl (no-op without
        a metrics_logger); called at the log cadence."""
        if self.metrics_logger is None:
            return
        for row in self.history[self._history_flushed:]:
            self.metrics_logger.log(row)
        self._history_flushed = len(self.history)

    def _warn_overflow(self, overflow: float, where: str):
        """The JAX Trainer's warning for instances dropped at the cap (the
        port sizes each render's buffer exactly, so any drop is at it)."""
        if overflow > 0:
            self.log_fn(f"WARNING: instance overflow {int(overflow)} at the "
                        f"max_instances cap {self.cfg.instance_cap} "
                        f"({where}): suffix tiles render EMPTY — quality is "
                        "compromised while this persists")

    def track_frame(self, t: int):
        if t > 1 and self.pose_init == "pnp":
            self.poses = posemod.pnp_pose_init(
                self.poses, t, self.flows_fw[t - 1],
                self.state.pred_depths[t - 1].to(torch.float32),
                self.poses.w2c(t - 1).detach(), self.cam, seed=self.seed + t)
        elif t > 1:
            self.poses = posemod.const_velocity_init(self.poses, t)
        elif t == 1:
            self.poses = posemod.copy_previous_init(self.poses, t)
        rigid = self._rigid_mask(t)
        with torch.no_grad():
            prev_w2c = self.poses.w2c(t - 1)
        q, tr, metrics = tracking_loop(
            self.field, self.poses.quats[t], self.poses.trans[t],
            self.colors[t], self.state.pred_depths[t - 1], prev_w2c,
            self.flows_fw[t - 1], rigid, self.cam, self.cfg,
            sh_degree=self.active_sh_degree)
        self.poses = self.poses.set_frame(t, q, tr)
        return metrics

    def progressive_run(self):
        i_train = set(int(i) for i in np.asarray(self.seq.i_train))
        t0 = time.time()
        for t in range(self.num_frames):
            t_frame = time.time()
            metrics: dict = {}
            overflow = []       # instances dropped at the cap, every render
            if t > 0:
                metrics = self.track_frame(t)
                overflow.append(metrics["overflow"])
            if t not in i_train and self.cache_test_frames:
                # an unmapped (test) frame: render it into the caches so
                # the next frame's flow loss and GN solve have a depth
                out = self.render_frame(t)
                overflow.append(out["overflow"])
                with torch.no_grad():
                    self.state.pred_depths[t] = out["render_dep"].to(
                        torch.bfloat16)
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
                if self.panel_fn is not None and t % self.panel_every == 0:
                    self._emit_panel(t)
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
        self._flush_history()

    def global_run(self, iters: int | None = None):
        """``iters`` single-view mapping iterations over random train frames
        (cfg.global_iters when None), in chunks of ``global_chunk``. The
        cadences (checkpoints, pose BA, validation, logs) count the total
        over all calls, which the history rows record as ``iter``. With
        cfg.rebin_every > 1 each chunk visits its draws in sorted order, so
        that runs of one frame reuse its binning layout (the same multiset
        from the same stream)."""
        iters = iters if iters is not None else self.cfg.global_iters
        i_train = np.asarray(self.seq.i_train, np.int64)
        rng = self._global_rng
        with torch.no_grad():
            w2c_all = self.poses.all_w2c()
        done = 0
        t0 = time.time()
        while done < iters:
            self._update_sh_degree()
            n = min(self.global_chunk, iters - done)
            ts_np = rng.choice(i_train, size=n)
            if self.cfg.rebin_every > 1:
                ts_np = np.sort(ts_np)
            ts = [int(t) for t in ts_np]
            self.state, aux = mapping_chunk(
                self.state, self.colors, self.monodeps, w2c_all, ts, [],
                self.cam, self.cfg, two_views=False,
                sh_degree=self.active_sh_degree, densify_enabled=True)
            done += n
            self._maybe_grow()
            self._global_done += n
            total = self._global_done
            # before the checkpoint, so that it holds the refined poses
            if self.pose_ba_every and total % self.pose_ba_every < n:
                w2c_all = self._pose_ba_pass(total)
            if self.checkpoint_dir and total % self.checkpoint_every < n:
                self.save(f"{self.checkpoint_dir}/ckpt_{total:07d}")
            if total % 1000 < n:
                terms = aux["loss_terms"]
                dt = {k: int(v) for k, v in aux["densify_totals"].items()
                      if float(v) > 0}
                self.log_fn(
                    f"[global {total}] loss={float(aux['loss']):.4f}"
                    f" rgb={float(terms[0]):.4f} pear={float(terms[1]):.4f}"
                    f" lp={float(terms[2]):.4f}"
                    f" active={int(aux['num_active'])}"
                    + (f" densify={dt}" if dt else "")
                    + f" ({time.time() - t0:.1f}s)")
                self._report_nonfinite(aux, f"global {total}")
            self.history.append({"stage": "global", "iter": total,
                                 "loss": float(aux["loss"]),
                                 "num_active": int(aux["num_active"]),
                                 "overflow": float(aux["overflow_max"])})
            self._warn_overflow(self.history[-1]["overflow"],
                                f"global {total}")
            if self.validation_every and total % self.validation_every < n:
                val = self.validation()
                self.history.append({"stage": "global_val", "iter": total,
                                     **{k: v for k, v in val.items()
                                        if isinstance(v, (int, float))}})
            if total % 1000 < n:
                self._flush_history()
        self._flush_history()

    def _pose_ba_pass(self, total: int):
        """One global-stage pose-BA pass: refine every train-frame pose but
        frame 0's against the frozen map (test frames stay as tracked).
        Returns the w2c table the following chunks map with."""
        ts = [int(t) for t in np.asarray(self.seq.i_train) if t != 0]
        quats, trans, best, overflow = refine_poses_scan(
            self.field, self.poses.quats, self.poses.trans, self.colors, ts,
            self.cam, iters=self.pose_ba_iters, lr=self.pose_ba_lr,
            sh_degree=self.active_sh_degree,
            max_instances=self.cfg.instance_cap)
        self.poses = PoseTable(quats=quats, trans=trans)
        mean_loss = float(best.mean())
        self.log_fn(f"[global {total}] pose-BA pass over {len(ts)} train "
                    f"frames: mean photometric loss {mean_loss:.4f}")
        self.history.append({"stage": "pose_ba", "iter": total,
                             "mean_loss": mean_loss,
                             "overflow": float(overflow)})
        with torch.no_grad():
            return self.poses.all_w2c()

    def _report_nonfinite(self, aux, where: str):
        if float(aux["nonfinite_grads"]) <= 0:
            return
        groups = {k: int(v) for k, v in aux["nonfinite_by_group"].items()
                  if float(v) > 0}
        self.log_fn(f"NONFINITE grads at {where}: "
                    f"total={float(aux['nonfinite_grads']):.3g} "
                    f"first_iter={int(aux['first_nonfinite_iter'])} "
                    f"by_group={groups}")

    # --------------------------------------------------------- evaluation
    def render_frame(self, t: int):
        f = self.field
        with torch.no_grad():
            return render(f.means, f.quats, f.log_scales, f.logit_opacity,
                          f.sh, self.poses.w2c(t), self.cam, active=f.active,
                          sh_degree=self.active_sh_degree,
                          max_instances=self.cfg.instance_cap)

    def _emit_panel(self, t: int, name: str = "compare"):
        """Hand ``panel_fn`` frame t's labelled render | gt | depth |
        monodep | flow panel (no flow for the last frame), named
        ``<name>_f<t:04d>``, at the current iteration (no-op without a
        panel_fn)."""
        if self.panel_fn is None:
            return
        out = self.render_frame(t)

        def np_(x):
            return x.cpu().numpy()

        parts = [add_label(np_(torch.clamp(out["render"], 0, 1)), "render"),
                 add_label(np_(self.colors[t]), "gt"),
                 add_label(colorize_depth(np_(out["render_dep"])), "depth"),
                 add_label(colorize_depth(np_(self.monodeps[t])), "monodep")]
        if t + 1 < self.num_frames:
            parts.append(add_label(colorize_flow(np_(self.flows_fw[t])),
                                   "flow"))
        self.panel_fn(f"{name}_f{t:04d}", hcat(*parts),
                      int(self.state.iteration))

    def _render_stack(self, frames):
        """Clamped renders and ground truths of ``frames`` as (N, 3, H, W)
        numpy stacks, and the largest overflow of those renders."""
        preds, gts, overflow = [], [], 0.0
        for t in frames:
            out = self.render_frame(t)
            overflow = max(overflow, float(out["overflow"]))
            preds.append(torch.clamp(out["render"], 0, 1).cpu().numpy())
            gts.append(self.colors[t].cpu().numpy())
        return np.stack(preds), np.stack(gts), overflow

    def validation(self, include_train: bool = False) -> dict:
        """Test-view PSNR / SSIM / LPIPS (with ``lpips_backend``) and pose
        metrics when the sequence has gt_poses. ``include_train`` adds
        psnr_train over every 8th train view (map quality apart from pose
        error). ``overflow`` is the largest of these renders' (not in the
        JAX package, which does not check it here)."""
        metrics: dict = {}
        test = [int(i) for i in np.asarray(self.seq.i_test)]
        overflow = 0.0
        if test:
            preds, gts, overflow = self._render_stack(test)
            metrics.update(rgb_evaluation(gts, preds,
                                          device=self.colors.device))
            for t in test:
                self._emit_panel(t, name="val")
        if include_train:
            train = [int(i) for i in np.asarray(self.seq.i_train)][::8]
            preds, gts, ov = self._render_stack(train)
            metrics["psnr_train"] = psnr(gts, preds)
            overflow = max(overflow, ov)
        metrics["overflow"] = overflow
        self._warn_overflow(overflow, "validation")
        if getattr(self.seq, "gt_poses", None):
            with torch.no_grad():
                pred_w2c = self.poses.all_w2c().cpu().numpy()
            metrics.update(evaluate_subsequences(
                pred_w2c, self.seq.gt_poses, self.seq.boundaries))
        self.log_fn("validation: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()
            if isinstance(v, (float, str))))
        return metrics

    # ------------------------------------------------------- persistence
    def save(self, path: str):
        save_checkpoint(path, self._ckpt_tree(self.capture()),
                        self.state.iteration, meta=self._shape_meta())

    def capture(self) -> dict:
        return {"state": self.state, "poses": self.poses,
                "keyframes": list(self.keyframes),
                "active_sh_degree": self.active_sh_degree}

    @staticmethod
    def _ckpt_tree(cap) -> dict:
        """The checkpoint's tree of tensors and plain values (what
        ``torch.load(weights_only=True)`` reads back). The prediction caches,
        the bulk of a full-res checkpoint, are stored bf16, as they live."""
        st = cap["state"]
        f = st.field
        return {
            "state": {
                "field": {**{k: getattr(f, k) for k in FIELD_KEYS},
                          "max_sh_degree": f.max_sh_degree},
                "opt": {"mu": st.opt.mu, "nu": st.opt.nu,
                        "count": st.opt.count},
                "iteration": st.iteration,
                "generator": st.generator.get_state(),
                "pred_depths": st.pred_depths.to(torch.bfloat16),
                "pred_colors": st.pred_colors.to(torch.bfloat16)},
            "poses": {"quats": cap["poses"].quats,
                      "trans": cap["poses"].trans},
            "keyframes": cap["keyframes"],
            "active_sh_degree": cap["active_sh_degree"]}

    def _shape_meta(self) -> dict:
        return {"capacity": self.field.capacity,
                "n_keyframes": len(self.keyframes),
                "sh_rest_k": int(self.field.sh_rest.shape[1]),
                "num_frames": self.num_frames,
                "max_instances": int(self.cfg.max_instances or 0),
                "global_done": self._global_done}

    def restore(self, path: str):
        """Restore a checkpoint, also into a freshly built Trainer whose
        capacity or keyframe count differ from save time: the sidecar's
        shapes re-shape this Trainer first, and every restored tensor must
        then match the shape it replaces."""
        meta = load_checkpoint_meta(path)
        if meta is not None:
            if meta["num_frames"] != self.num_frames:
                raise ValueError(
                    f"checkpoint has {meta['num_frames']} frames, the "
                    f"sequence {self.num_frames}")
            if meta["sh_rest_k"] != self.field.sh_rest.shape[1]:
                raise ValueError("sh_degree differs between the checkpoint "
                                 "and this Trainer")
            self._resize_capacity(meta["capacity"])
            self._global_done = int(meta.get("global_done", 0))
            if meta.get("max_instances"):
                self.cfg = self.cfg._replace(
                    max_instances=meta["max_instances"])
        tree, _ = restore_checkpoint(path, map_location="cpu")
        template = self._ckpt_tree(self.capture())

        def put(new, old, name):
            if torch.is_tensor(old):
                if tuple(new.shape) != tuple(old.shape):
                    raise ValueError(f"checkpoint {name} has shape "
                                     f"{tuple(new.shape)}, expected "
                                     f"{tuple(old.shape)}")
                return new.to(device=old.device, dtype=old.dtype)
            if isinstance(old, dict):
                return {k: put(new[k], v, f"{name}.{k}")
                        for k, v in old.items()}
            return new

        st = put(tree["state"], template["state"], "state")
        gen = torch.Generator()
        gen.set_state(tree["state"]["generator"])
        self.state = MappingState(
            field=GaussianField(**st["field"]),
            opt=AdamState(mu=st["opt"]["mu"], nu=st["opt"]["nu"],
                          count=int(st["opt"]["count"])),
            iteration=int(st["iteration"]), generator=gen,
            pred_depths=st["pred_depths"], pred_colors=st["pred_colors"])
        self.poses = PoseTable(**put(tree["poses"], template["poses"],
                                     "poses"))
        self.keyframes = [int(k) for k in tree["keyframes"]]
        self.active_sh_degree = int(tree["active_sh_degree"])
