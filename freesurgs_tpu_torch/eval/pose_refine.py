"""Pose-only photometric refinement against a frozen map
(port of ``freesurgs_tpu/eval/pose_refine.py``).

Adam on one frame's (quat, trans) with the Gaussians frozen
(``gs_grad=False, cam_grad=True``), the unmasked photometric loss and a
learning rate that decays from ``lr`` to ``0.1 lr``. The pose returned is
the best of the ``iters`` poses evaluated, the initial one included
(strict ``<``), so a refinement never leaves a pose worse than it found
it; the first pose evaluated is the initial one, whose loss it returns
too. ``refine_poses_scan`` runs it over a list of frames: the global
stage's pose-BA pass (``Trainer.pose_ba_every``).

Every render goes through the compositing kernels on the card, fresh
binning each time, and each iteration's graph is freed by its
``autograd.grad``. The JAX ``make_jitted_refine`` / ``make_jitted_refine_scan``
have no counterpart: these are eager loops. Both functions also return the
largest ``overflow`` of their renders (JAX checks none).
"""

from __future__ import annotations

import torch

from ..core.camera import Camera
from ..core.transforms import build_w2c
from ..models.gaussians import GaussianField
from ..ops.render import render
from ..train import losses
from ..train.optim import adam_init, adam_update, apply_updates


def refine_pose(field: GaussianField, quat0, trans0, gt_image, cam: Camera,
                *, iters: int = 100, lr: float = 3e-3, sh_degree: int = 0,
                max_instances: int = 0, grad_sum: str = "direct"):
    """Optimize one frame's (quat, trans) photometrically; field frozen.
    Returns (quat, trans, best_loss, overflow, start_loss), all on the
    device: no host read. ``start_loss`` is the loss at (quat0, trans0),
    the first pose evaluated, so ``best_loss <= start_loss``. ``grad_sum``:
    the renders' backward reduction (``ops/render.render``)."""
    dev = quat0.device
    pose = {"q": quat0.detach().clone(), "t": trans0.detach().clone()}
    opt = adam_init(pose)
    best_loss = torch.tensor(float("inf"), device=dev)
    best = dict(pose)
    overflow = torch.zeros((), device=dev)
    start_loss = best_loss
    for i in range(iters):
        q = pose["q"].detach().requires_grad_(True)
        t = pose["t"].detach().requires_grad_(True)
        out = render(field.means, field.quats, field.log_scales,
                     field.logit_opacity, field.sh, build_w2c(q, t), cam,
                     active=field.active, sh_degree=sh_degree,
                     max_instances=max_instances, gs_grad=False,
                     cam_grad=True, grad_sum=grad_sum)
        overflow = torch.maximum(overflow, out["overflow"].to(torch.float32))
        # unmasked: with no flow anchor a coverage mask would let the
        # optimizer shrink the evaluated region to easy pixels
        loss = losses.rgb_loss(out["render"], gt_image)
        gq, gt = torch.autograd.grad(loss, (q, t))
        q, t, loss = q.detach(), t.detach(), loss.detach()
        if i == 0:
            start_loss = loss
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        best = {"q": torch.where(better, q, best["q"]),
                "t": torch.where(better, t, best["t"])}
        grads = {k: torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                 for k, g in (("q", gq), ("t", gt))}
        cur_lr = lr * (0.1 + 0.9 * (1.0 - i / max(iters, 1)))
        upd, opt = adam_update(grads, opt, cur_lr)
        pose = apply_updates({"q": q, "t": t}, upd)
    return best["q"], best["t"], best_loss, overflow, start_loss


def refine_poses_scan(field: GaussianField, quats_all, trans_all,
                      colors_all, ts, cam: Camera, *, iters: int = 25,
                      lr: float = 1e-3, sh_degree: int = 0,
                      max_instances: int = 0, grad_sum: str = "direct"):
    """Refine the poses of frames ``ts`` (host ints; usually the train
    frames but the pinned frame 0) against the frozen map, one after
    another. Returns (quats_all, trans_all) with the rows at ``ts``
    replaced (new tensors; the others bitwise unchanged), the (K,) best
    losses, the largest overflow and the (K,) start losses."""
    quats_all, trans_all = quats_all.clone(), trans_all.clone()
    best, start = [], []
    overflow = torch.zeros((), device=quats_all.device)
    for t in ts:
        q, tr, loss, ov, loss0 = refine_pose(
            field, quats_all[t], trans_all[t], colors_all[t], cam,
            iters=iters, lr=lr, sh_degree=sh_degree,
            max_instances=max_instances, grad_sum=grad_sum)
        quats_all[t], trans_all[t] = q, tr
        best.append(loss)
        start.append(loss0)
        overflow = torch.maximum(overflow, ov)
    empty = torch.zeros(0, device=quats_all.device)
    return (quats_all, trans_all, torch.stack(best) if best else empty,
            overflow, torch.stack(start) if start else empty)
