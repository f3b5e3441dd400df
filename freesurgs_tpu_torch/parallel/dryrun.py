"""The JAX package's multi-chip dry run (``__graft_entry__.dryrun_multichip``)
on the port, one process per rank:

    torchrun --nproc_per_node 2 -m freesurgs_tpu_torch.parallel.dryrun
    torchrun --nproc_per_node 4 -m freesurgs_tpu_torch.parallel.dryrun \\
        --device cpu

On a mesh of every rank (two data rows of tile ranks from 4 ranks up, when
their number is even; one row else), from a perturbed field of a 48x48
synthetic scene: one band-sharded ``mapping_chunk`` step (its loss above
1e-3, the field moved), a ``tracking_loop`` with 2 GN iterations and 5
Adam steps (the pose moved) and, with two rows, a
``multiseq_mapping_chunk``; each result bitwise equal on every rank.
Raises on a failed check.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from ..data.synthetic import make_scene
from ..models.gaussians import GaussianField
from ..train.optim import adam_init
from ..train.steps import MappingState, TrainConfig, mapping_chunk, \
    tracking_loop
from .mesh import (DATA_AXIS, TILE_AXIS, Mesh, initialize_multihost,
                   make_mesh, same_on_all_ranks)
from .multiseq import multiseq_mapping_chunk, shard_states, stack_states

CAPACITY = 256


def perturbed_state(scene, seed: int = 1) -> MappingState:
    """The scene's Gaussians moved off the ones that rendered its frames
    (means +0.03 N(0, 1), log-scales +0.2 N(0, 1), colors +0.1 N(0, 1),
    opacity logits -0.5), in a slot pool of CAPACITY, as the JAX dry run
    builds its field, from a CPU generator."""
    g = torch.Generator().manual_seed(seed)
    n = scene.means.shape[0]
    dev = scene.means.device

    def noise(x, s):
        return x + s * torch.randn(x.shape, generator=g).to(dev)

    def pad(x):
        out = x.new_zeros((CAPACITY,) + tuple(x.shape[1:]))
        out[:n] = x
        return out

    quats = pad(scene.quats)
    quats[n:, 0] = 1.0
    zeros = torch.zeros(CAPACITY, device=dev)
    field = GaussianField(
        means=pad(noise(scene.means, 0.03)), quats=quats,
        log_scales=pad(noise(scene.log_scales, 0.2)),
        logit_opacity=pad(scene.logit_opacity - 0.5),
        sh_dc=pad(noise(scene.sh[:, :1], 0.1)),
        sh_rest=torch.zeros(CAPACITY, 0, 3, device=dev),
        active=torch.arange(CAPACITY, device=dev) < n, max_radii2d=zeros,
        grad_accum=zeros.clone(), grad_denom=zeros.clone(),
        scene_radius=torch.tensor(1.5, device=dev), max_sh_degree=0)
    t, (h, w) = scene.colors.shape[0], scene.colors.shape[2:]
    return MappingState(
        field=field, opt=adam_init(field.param_dict()), iteration=0,
        generator=torch.Generator().manual_seed(0),
        pred_depths=torch.zeros(t, h, w, device=dev),
        pred_colors=torch.zeros(t, 3, h, w, device=dev))


def run(mesh: Mesh) -> dict:
    """The dry run's checks on ``mesh`` (every rank calls it)."""
    dev = mesh.device
    scene = make_scene(num_frames=2, n_gaussians=128, height=48, width=48,
                       seed=0, device=dev)
    cam = scene.cam
    cfg = TrainConfig(max_instances=2048, densify_interval=10)
    state = perturbed_state(scene)
    field0 = state.field
    st, aux = mapping_chunk(state, scene.colors, scene.monodeps,
                            scene.gt_w2c, [0], [], cam, cfg,
                            two_views=False, sh_degree=0,
                            densify_enabled=True, mesh=mesh)
    loss = float(aux["loss"])
    move = float((st.field.means - field0.means).abs().sum())
    if not loss > 1e-3:
        raise AssertionError(f"dry-run loss {loss} is trivial")
    if not move > 0.0:
        raise AssertionError("the mapping step did not move the field")

    tcfg = cfg._replace(tracking_iters=5, tracking_gn_iters=2)
    q0, t0 = scene.gt_quats[0], scene.gt_trans[0]
    q1, t1, tmet = tracking_loop(
        field0, q0, t0, scene.colors[1], scene.depths[0], scene.gt_w2c[0],
        scene.flows_fw[0], torch.ones(cam.height, cam.width, device=dev),
        cam, tcfg, sh_degree=0, mesh=mesh)
    pose_move = float(torch.linalg.norm(t1 - t0) + torch.linalg.norm(q1 - q0))
    if not pose_move > 0.0:
        raise AssertionError("the tracking step did not move the pose")
    checked = [st.field.means, st.field.logit_opacity, st.field.grad_denom,
               q1, t1]

    res = {"loss": loss, "field_moved": move, "pose_moved": pose_move,
           "gn_weight": float(tmet["gn_weight"]), "mesh": dict(mesh.shape)}
    d = mesh.shape[DATA_AXIS]
    if d > 1:
        stacked = stack_states([perturbed_state(scene) for _ in range(d)])
        ms, aux2 = multiseq_mapping_chunk(
            mesh, shard_states(mesh, stacked),
            torch.stack([scene.colors] * d), torch.stack([scene.monodeps] * d),
            torch.stack([scene.gt_w2c] * d), torch.zeros(d, 1, dtype=int),
            cam, cfg)
        if not (aux2["loss"].shape == (d,)
                and bool(torch.isfinite(aux2["loss"]).all())):
            raise AssertionError(f"multiseq losses {aux2['loss']}")
        res["multiseq_loss"] = aux2["loss"].tolist()
        checked.append(ms.field.means)
    if not same_on_all_ranks(checked):
        raise AssertionError("the ranks' results differ")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for a CPU mesh (default: each rank's card)")
    args = ap.parse_args(argv)
    world, rank = initialize_multihost(device=args.device)
    data_par = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(data_parallel=data_par, device=args.device)
    res = run(mesh)
    if rank == 0:
        print(f"dryrun ({world} ranks, tiles {mesh.shape[TILE_AXIS]}): ok "
              f"{res}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
