"""Training steps: per-frame tracking and mapping
(port of ``freesurgs_tpu/train/steps.py``).

Weights and schedules are the reference's (train.py):

  tracking: 1.0 * rgb(masked) + 0.1 * flow-reprojection, Adam lr 0.01
            halved at 0, 1/3 and 2/3 of the budget;
  mapping:  5.0 * rgb + 0.05 * pearson + 0.15 * local-pearson against the
            monocular depth prior, per-group Adam LRs, densify every 300
            global mapping iterations below 15000, opacity reset every 3000.

Where the JAX package scans a whole loop inside one jitted call, these are
Python loops of eager PyTorch; every render goes through the compositing
kernels (``ops/raster_cuda.py``) on the card. With a ``mesh``
(``parallel/mesh.py``) every render is band-sharded over its tiles group
(``parallel/sharded.py``) and the binning-layout carry is off, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.camera import Camera
from ..core.transforms import build_w2c
from ..models.gaussians import PARAM_NAMES, GaussianField
from ..ops.raster_cuda import GRAD_SUMS
from ..ops.render import DEFAULT_MAX_INSTANCES, render
from ..parallel.sharded import render_sharded_full
from ..utils.profiling import span
from . import losses
from .densify import (DensifyConfig, add_render_stats, densify_and_prune,
                      reset_opacity, split_noise)
from .flow_pnp import flow_pnp_refine
from .keyframes import keyframe_overlap_scores, select_overlap_keyframes
from .optim import (AdamState, adam_init, adam_update, apply_updates,
                    expon_lr, tracking_lr)


class TrainConfig(NamedTuple):
    """The reference's hyper-parameters, with the JAX package's fields and
    defaults (``check_supported`` says what the port refuses)."""
    tracking_iters: int = 50
    mapping_iters: int = 30
    first_frame_mapping_iters: int = 200
    global_iters: int = 30000
    densify_interval: int = 300
    densify_until: int = 15000
    opacity_reset_interval: int = 3000
    size_threshold_from: int = 4000
    sh_increase_interval: int = 1000
    w_rgb_tracking: float = 1.0
    w_flow_tracking: float = 0.1
    w_rgb_mapping: float = 5.0
    w_pearson: float = 0.05
    w_local_pearson: float = 0.15
    spatial_lr_scale: float = 5.0
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_max_steps: int = 30000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    keyframe_policy: str = "uniform"
    rebin_every: int = 1
    rebin_tracking_every: int = 1
    tracking_gn_iters: int = 8
    tracking_gn_huber_px: float = 2.0
    # Cap on the instance buffer; 0 -> max_instances_cap. The binner sizes
    # the buffer exactly on every call below the cap.
    max_instances: int = 0
    max_instances_cap: int = DEFAULT_MAX_INSTANCES
    # The backward's per-Gaussian reduction in every training render
    # (tracking, mapping, pose BA): "direct", or "prefix", the JAX
    # package's default (fast_binning=True; ops/raster_cuda.RasterConfig).
    # Not in the JAX TrainConfig, whose renders always take the default.
    grad_sum: str = "direct"
    # Kept for field parity with the JAX package; the port renders through
    # its compositing kernels only (check_supported).
    impl: str | None = None
    densify: DensifyConfig = DensifyConfig()

    @property
    def instance_cap(self) -> int:
        return self.max_instances or self.max_instances_cap

    def mapping_lrs(self, step: int, device=None) -> dict[str, torch.Tensor]:
        xyz = expon_lr(step, self.position_lr_init * self.spatial_lr_scale,
                       self.position_lr_final * self.spatial_lr_scale,
                       self.position_lr_max_steps, device=device)

        def c(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return {"means": xyz, "quats": c(self.rotation_lr),
                "log_scales": c(self.scaling_lr),
                "logit_opacity": c(self.opacity_lr),
                "sh_dc": c(self.feature_lr),
                "sh_rest": c(self.feature_lr / 20.0)}


def check_supported(cfg: TrainConfig) -> None:
    """Raise for what the port does not run instead of running something
    else quietly."""
    if cfg.impl not in (None, "raster"):
        raise NotImplementedError(
            f"impl={cfg.impl!r}: the port renders only through its "
            "compositing kernels (impl=None or 'raster'); the dense oracle "
            "is a test reference (ops/oracle.py)")
    if cfg.grad_sum not in GRAD_SUMS:
        raise ValueError(f"grad_sum={cfg.grad_sum!r}: one of {GRAD_SUMS}")
    if cfg.keyframe_policy not in ("uniform", "overlap"):
        raise ValueError(f"keyframe_policy={cfg.keyframe_policy!r}: "
                         "'uniform' or 'overlap'")


def _isfinite_count(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(~torch.isfinite(g)).to(torch.float32)


def _finite(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _render(mesh, means, quats, log_scales, logit_opacity, sh, w2c, cam, *,
            bins=None, rebin=None, **kw):
    """``render``, or with a mesh its band-sharded counterpart (JAX
    ``steps.py:151-165`` / ``_render_view``), which carries no layout."""
    if mesh is None:
        return render(means, quats, log_scales, logit_opacity, sh, w2c, cam,
                      bins=bins, rebin=rebin, **kw)
    return render_sharded_full(mesh, means, quats, log_scales, logit_opacity,
                               sh, w2c, cam, **kw)


# ------------------------------------------------------------- tracking

def tracking_loop(field: GaussianField, quat0, trans0, gt_image, prev_depth,
                  prev_w2c, flow_fw_prev, rigid_mask, cam: Camera,
                  cfg: TrainConfig, sh_degree: int = 0, mesh=None):
    """Optimize one frame's (quat, trans) for cfg.tracking_iters Adam steps
    with the Gaussians frozen. Returns (quat, trans, metrics).

    With cfg.rebin_tracking_every > 1 the binning layout is carried across
    iterations and rebuilt when i % rebin_tracking_every == 0, unless a
    ``mesh`` band-shards the renders (the carry is then off).

    With cfg.tracking_gn_iters > 0 the pose is first refined by the
    Gauss-Newton flow-PnP solve (train/flow_pnp.py) on the same inputs as
    the flow loss; a frame whose previous depth cache is empty carries zero
    GN weight and keeps its init."""
    check_supported(cfg)
    gn_diag = None
    if cfg.tracking_gn_iters > 0:
        with span("track.gn"):
            quat0, trans0, gn_diag = flow_pnp_refine(
                quat0, trans0, prev_depth, prev_w2c, flow_fw_prev, cam,
                rigid_mask=rigid_mask, iters=cfg.tracking_gn_iters,
                huber_px=cfg.tracking_gn_huber_px)
    pose = {"q": quat0.detach().clone(), "t": trans0.detach().clone()}
    opt = adam_init(pose)
    dev = quat0.device
    sh = field.sh
    nonfinite = torch.zeros((), device=dev)
    overflow_max = torch.zeros((), device=dev)
    zero = torch.zeros((), device=dev)
    last = (zero, zero, zero)      # JAX's fori_loop carry: zeros at 0 iters
    carry = cfg.rebin_tracking_every > 1 and mesh is None
    bins = None
    for i in range(cfg.tracking_iters):
        with span("track.iter"):
            q = pose["q"].requires_grad_(True)
            t = pose["t"].requires_grad_(True)
            w2c = build_w2c(q, t)
            out = _render(mesh, field.means, field.quats, field.log_scales,
                          field.logit_opacity, sh, w2c, cam,
                          active=field.active, sh_degree=sh_degree,
                          max_instances=cfg.instance_cap, gs_grad=False,
                          cam_grad=True, bins=bins,
                          rebin=(i % cfg.rebin_tracking_every == 0) if carry
                          else None, grad_sum=cfg.grad_sum)
            bins = out.get("bins")
            overflow_max = torch.maximum(overflow_max,
                                         out["overflow"].to(torch.float32))
            mask = (out["render_dep"] > 0) & (rigid_mask > 0)
            rgb = cfg.w_rgb_tracking * losses.rgb_loss(
                out["render"], gt_image, mask=mask)
            flow = cfg.w_flow_tracking * losses.flow_projection_loss(
                prev_depth, prev_w2c, out["render_w2c"], flow_fw_prev, cam,
                rigid_mask=rigid_mask)
            loss = rgb + flow
            gq, gt = torch.autograd.grad(loss, (q, t))
            # NaN guard: one non-finite gradient must not poison the pose
            nonfinite = nonfinite + _isfinite_count(gq) + \
                _isfinite_count(gt)
            grads = {"q": _finite(gq), "t": _finite(gt)}
            lr = tracking_lr(i, cfg.tracking_iters, device=dev)
            upd, opt = adam_update(grads, opt, lr)
            pose = apply_updates({"q": q.detach(), "t": t.detach()}, upd)
            last = (loss.detach(), rgb.detach(), flow.detach())
    metrics = {"loss": last[0], "rgb_loss": last[1], "flow_loss": last[2],
               "nonfinite_grads": nonfinite, "overflow": overflow_max}
    if gn_diag is not None:
        # final Huber-weighted mean residual (px) and the effective point
        # weight; a weight below flow_pnp_refine's min_weight (64) means the
        # degenerate-frame guard kept the init
        metrics["gn_resid_px"] = gn_diag[0]
        metrics["gn_weight"] = gn_diag[1]
    return pose["q"], pose["t"], metrics


# -------------------------------------------------------------- mapping

@dataclasses.dataclass
class MappingState:
    field: GaussianField
    opt: AdamState
    iteration: int                 # global mapping-step counter
    generator: torch.Generator     # CPU generator: keyframe draws,
                                   # local-Pearson boxes, split noise
    pred_depths: torch.Tensor      # (T, H, W) bf16 rendered-depth cache
    pred_colors: torch.Tensor      # (T, 3, H, W) bf16 rendered-color cache


_GROUPS = PARAM_NAMES + ("probe2d",)
_DENSIFY_KEYS = ("cloned", "split", "pruned_opacity", "pruned_world",
                 "pruned_screen", "dropped")


def _overlap_keyframe(monodeps_all, w2c_all, cur_t, kf, cam, gen):
    """The keyframe view's frame under keyframe_policy="overlap", as a 0-d
    device tensor (no host read). JAX scores a keyframe array zero-padded
    to the number of frames, with the padding's scores zeroed, so when no
    keyframe overlaps it picks the LAST padded position: frame 0 unless
    every frame is a keyframe. The padding here reproduces that pick."""
    pad = w2c_all.shape[0] - len(kf)
    scores = keyframe_overlap_scores(monodeps_all[cur_t], w2c_all[cur_t],
                                     w2c_all[kf], cam, gen)
    scores = torch.cat([scores, scores.new_zeros(pad)])
    pos = select_overlap_keyframes(scores, gen, 1)[0]
    return torch.tensor(kf + [0] * pad, device=scores.device)[pos]


def mapping_chunk(state: MappingState, colors_all, monodeps_all, w2c_all,
                  cur_ts, keyframes, cam: Camera, cfg: TrainConfig,
                  two_views: bool, sh_degree: int,
                  densify_enabled: bool = True, mesh=None):
    """Run ``len(cur_ts)`` mapping iterations.

    cur_ts: the frame mapped at each iteration (host ints). two_views adds a
    keyframe view per iteration (from ``keyframes``, a host list; empty ->
    frame 0), drawn uniformly or, with keyframe_policy="overlap", among the
    keyframes the current frame's monodepth prior overlaps; densify
    statistics come from that view only. Densify fires every
    cfg.densify_interval global iterations below cfg.densify_until and the
    opacity reset every cfg.opacity_reset_interval. After each iteration
    the mapped frame's rendered depth/color go into the bf16 prediction
    caches.

    With cfg.rebin_every > 1 each view carries its binning layout across
    iterations (JAX ``steps.py:442-499``). With k the index in the chunk,
    the current view rebins when force | cur_t != prev_t |
    k % rebin_every == 0, force being the previous iteration's slot surgery
    (densify or opacity reset) and true at k = 0. Under uniform keyframes
    the chunk's keyframe draws are made up front and sorted, and the
    keyframe view rebins on force | a new keyframe | k % rebin_every == 0;
    under "overlap" it bins fresh every iteration. No carry outlives the
    call (capacity grows between calls). A ``mesh`` band-shards every
    render over its tiles group and turns the carry off (JAX
    ``steps.py:442``).
    Returns (state, aux) with last-iteration and chunk diagnostics;
    aux["keyframe_views"] is the (n,) frames of the keyframe view, None in
    one-view chunks.
    """
    check_supported(cfg)
    field, opt = state.field, state.opt
    iteration = state.iteration
    gen = state.generator
    dev = field.means.device
    H, W = cam.height, cam.width
    kf = list(keyframes) or [0]
    ndc_scale = torch.tensor([0.5 * W, 0.5 * H], device=dev)
    pred_depths, pred_colors = state.pred_depths, state.pred_colors

    zero = torch.zeros((), device=dev)
    nf_total = {k: zero for k in _GROUPS}
    dens_total = {k: zero for k in _DENSIFY_KEYS}
    n_densify = n_reset = 0
    overflow_max = zero
    inst_max = zero
    n_it = len(cur_ts)
    first_nf = torch.tensor(n_it, device=dev)    # n_it: none
    loss = terms = None

    amortize = cfg.rebin_every > 1 and mesh is None
    overlap = two_views and cfg.keyframe_policy == "overlap"
    if amortize and two_views and not overlap:
        # sorted draws: the same multiset, grouped so that runs of one
        # keyframe reuse its layout (JAX amortize_kf)
        kf_pos_seq = torch.sort(torch.randint(
            0, len(kf), (n_it,), generator=gen)).values.tolist()
    bins = kf_bins = None
    prev_t = prev_kf = None
    force = True
    kf_views = []

    for it_idx, cur_t in enumerate(cur_ts):
        with span("map.iter", request=iteration + 1):
            params = {k: v.detach().requires_grad_(True)
                      for k, v in field.param_dict().items()}
            probe = torch.zeros(field.capacity, 2, device=dev,
                                requires_grad=True)
            sh = torch.cat([params["sh_dc"], params["sh_rest"]], dim=1)
            period = amortize and it_idx % cfg.rebin_every == 0

            def view(t_idx, probe_t, bins_c, rebin):
                out = _render(mesh, params["means"], params["quats"],
                              params["log_scales"], params["logit_opacity"],
                              sh, w2c_all[t_idx], cam, active=field.active,
                              probe2d=probe_t, sh_degree=sh_degree,
                              max_instances=cfg.instance_cap, gs_grad=True,
                              cam_grad=False, bins=bins_c, rebin=rebin,
                              grad_sum=cfg.grad_sum)
                with span("loss"):
                    rgb = cfg.w_rgb_mapping * losses.rgb_loss(
                        out["render"], colors_all[t_idx])
                    mono = monodeps_all[t_idx]
                    pear = cfg.w_pearson * losses.pearson_depth_loss(
                        mono, out["render_dep"])
                    if cfg.w_local_pearson:
                        x0, y0 = losses.local_pearson_boxes(H, W, gen,
                                                            device=dev)
                        lpear = (cfg.w_local_pearson
                                 * losses.local_pearson_loss(
                                     mono, out["render_dep"], x0, y0))
                    else:
                        lpear = torch.zeros((), device=dev)
                    return (rgb + pear + lpear, out,
                            torch.stack([rgb, pear, lpear]))

            rebin = (force or cur_t != prev_t or period) if amortize else None
            if two_views:
                kf_rebin = None
                if overlap:
                    kf_t = _overlap_keyframe(monodeps_all, w2c_all, cur_t, kf,
                                             cam, gen)
                else:
                    if amortize:
                        pos = kf_pos_seq[it_idx]
                        kf_rebin = force or pos != prev_kf or period
                        prev_kf = pos
                    else:
                        pos = int(torch.randint(0, len(kf), (), generator=gen))
                    kf_t = kf[pos]
                kf_views.append(kf_t)
                l0, stats_out, _ = view(kf_t, probe, kf_bins, kf_rebin)
                l1, cur_out, terms_t = view(cur_t, None, bins, rebin)
                kf_bins = stats_out.get("bins")
                loss_t = l0 + l1
            else:
                loss_t, cur_out, terms_t = view(cur_t, probe, bins, rebin)
                stats_out = cur_out
            bins = cur_out.get("bins")
            prev_t = cur_t
            names = list(params)
            with span("backward"):
                grads = torch.autograd.grad(loss_t, [params[k] for k in names]
                                            + [probe])
            with span("update"):
                pgrads = dict(zip(names, grads[:-1]))
                probe_grad = grads[-1]
                iteration += 1

                # NaN guard with per-group counts (where numerical trouble
                # starts)
                nf = {k: _isfinite_count(pgrads[k]) for k in names}
                nf["probe2d"] = _isfinite_count(probe_grad)
                nf_iter = sum(nf.values())
                for k in _GROUPS:
                    nf_total[k] = nf_total[k] + nf[k]
                first_nf = torch.where((first_nf == n_it) & (nf_iter > 0),
                                       torch.tensor(it_idx, device=dev),
                                       first_nf)
                pgrads = {k: _finite(g) for k, g in pgrads.items()}
                probe_grad = _finite(probe_grad)

                field = add_render_stats(field, probe_grad,
                                         stats_out["radii"],
                                         stats_out["visibility"],
                                         grad_scale=ndc_scale)
                upd, opt = adam_update(pgrads, opt,
                                       cfg.mapping_lrs(iteration, dev))
                field = field.replace(**apply_updates(
                    {k: v.detach() for k, v in params.items()}, upd))

                force = False
                if densify_enabled:
                    if (iteration % cfg.densify_interval == 0
                            and iteration < cfg.densify_until):
                        noise = split_noise(field.capacity, gen, dev)
                        field, opt, ds = densify_and_prune(
                            field, opt, noise, cfg.densify,
                            use_screen_size=(iteration
                                             > cfg.size_threshold_from))
                        for k in _DENSIFY_KEYS:
                            dens_total[k] = dens_total[k] + getattr(ds, k)
                        n_densify += 1
                        # a slot may now hold another Gaussian
                        force = True
                    if iteration % cfg.opacity_reset_interval == 0:
                        field, opt = reset_opacity(field, opt)
                        n_reset += 1
                        force = True     # grouped in, as in JAX

                # prediction caches, written in place (the JAX package
                # rebuilds them)
                with torch.no_grad():
                    pred_depths[cur_t] = cur_out["render_dep"].to(
                        pred_depths.dtype)
                    pred_colors[cur_t] = torch.clamp(
                        cur_out["render"], 0.0, 1.0).to(pred_colors.dtype)
                for o in (stats_out, cur_out):    # the same dict in one-view
                    overflow_max = torch.maximum(
                        overflow_max, o["overflow"].to(torch.float32))
                inst_max = torch.maximum(inst_max, cur_out[
                    "num_instances"].to(torch.float32))
                loss = loss_t.detach()
                terms = terms_t.detach()

    state = MappingState(field=field, opt=opt, iteration=iteration,
                         generator=gen, pred_depths=pred_depths,
                         pred_colors=pred_colors)
    nonfinite = sum(nf_total.values())
    aux = {"loss": loss, "overflow_max": overflow_max,
           "nonfinite_grads": nonfinite,
           "loss_terms": terms,            # rgb / pearson / local-pearson
           "nonfinite_by_group": nf_total,
           "first_nonfinite_iter": first_nf,   # chunk length: none
           "iteration": iteration,
           "num_instances_max": inst_max,
           "densify_totals": dens_total,
           "densify_events": n_densify,
           "opacity_resets": n_reset,
           "num_active": field.num_active,
           # overlap picks are device tensors; uniform ones host ints,
           # copied once
           "keyframe_views": (None if not kf_views
                              else torch.stack(kf_views) if overlap
                              else torch.tensor(kf_views, device=dev))}
    return state, aux
