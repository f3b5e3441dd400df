"""Training orchestrator, progressive stage (port of
``freesurgs_tpu/train/loop.py``).

 1. frame 0: initialize the Gaussian field from a masked back-projection of
    the monocular depth prior, then first_frame_mapping_iters mapping
    iterations on frame 0;
 2. frames t > 0: constant-velocity pose init -> tracking (with the epipolar
    rigidity mask from frames t-2 / t-1) -> mapping on {random keyframe, t}
    for train frames; an unmapped test frame gets one render to keep the
    depth cache (the next frame's flow loss) alive.

The global stage, validation, pose BA, checkpoints and panels wait for a
later slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..core.camera import Camera
from ..models import pose as posemod
from ..models.gaussians import GaussianField, from_rgbd, grow_capacity
from ..models.pose import PoseTable, identity_poses
from ..ops.render import render
from .optim import adam_init
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
    """Holds the training state and drives the progressive stage.

    ``seq`` is any object with the VideoSequence interface: colors
    (T, 3, H, W), flows_fw (T-1, 2, H, W), monodeps (T, H, W), cam,
    i_train / i_test (numpy arrays or tensors).
    """

    seq: Any
    cfg: TrainConfig = TrainConfig()
    sh_degree_max: int = 3
    init_mask_frac: float = 0.1
    capacity: int | None = None
    seed: int = 6666
    log_fn: Any = print
    pose_init: str = "const_velocity"
    max_capacity: int = 589_824
    device: Any = "cuda"

    def __post_init__(self):
        if self.pose_init != "const_velocity":
            raise NotImplementedError(
                "pose_init='pnp' (pnp_pose_init) is ROADMAP Queue 1 item 6")
        check_supported(self.cfg, tracking=True)
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
        field = grow_capacity(self.field, new_cap)
        opt = self.state.opt

        def pad(x):
            return torch.cat([x, x.new_zeros((new_cap - cap,)
                                             + tuple(x.shape[1:]))])

        opt = dataclasses.replace(opt, mu={k: pad(v) for k, v in opt.mu.items()},
                                  nu={k: pad(v) for k, v in opt.nu.items()})
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

    def track_frame(self, t: int):
        if t > 1:
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
            if t not in i_train:
                # an unmapped (test) frame: render it into the caches so
                # the next frame's flow loss has a depth to reproject
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
            metrics["overflow"] = torch.stack(
                [o.to(torch.float32) for o in overflow]).max()
            if self.colors.is_cuda:
                torch.cuda.synchronize(self.colors.device)
            metrics["seconds"] = time.time() - t_frame
            self.history.append({"stage": "progressive", "frame": t,
                                 **metrics})
            if t % 10 == 0:
                self.log_fn(f"[progressive {t}/{self.num_frames}] "
                            + " ".join(f"{k}={float(v):.4g}"
                                       for k, v in metrics.items())
                            + f" ({time.time() - t0:.1f}s)")

    def _report_nonfinite(self, aux, where: str):
        if float(aux["nonfinite_grads"]) <= 0:
            return
        groups = {k: int(v) for k, v in aux["nonfinite_by_group"].items()
                  if float(v) > 0}
        self.log_fn(f"NONFINITE grads at {where}: "
                    f"total={float(aux['nonfinite_grads']):.3g} "
                    f"first_iter={int(aux['first_nonfinite_iter'])} "
                    f"by_group={groups}")

    def render_frame(self, t: int):
        f = self.field
        with torch.no_grad():
            return render(f.means, f.quats, f.log_scales, f.logit_opacity,
                          f.sh, self.poses.w2c(t), self.cam, active=f.active,
                          sh_degree=self.active_sh_degree,
                          max_instances=self.cfg.instance_cap)
