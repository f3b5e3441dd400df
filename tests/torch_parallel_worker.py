"""The ranks of tests/test_torch_parallel.py: one process per rank of a
4-rank gloo group on the CPU, each on one thread, running every collective
scenario of ``freesurgs_tpu_torch.parallel`` once on the inputs the test
wrote (``inputs.npz``), then the port's single-process counterparts
(``single_*``, each computed by one rank), and writing its results to
``rank<r>.npz``.

This module imports no JAX (the test module does), so the spawned ranks
stay free of it. The meshes, all over the same 4 ranks:

- 1 x 4 (``tiles`` 4): 16 px bands at 64 rows, half a 32 px bin each;
- 2 x 2: two rows of 2 bands;
- 4 x 1: four sequences, one rank each.

The band-sharded renders and a mapping chunk also run with
``grad_sum="prefix"`` (``p``-prefixed keys); on the 2 x 2 mesh each rank
also writes its band's records, layout and prefix sums as it rendered
them (``prefix_band<r>.npz``), which differ from rank to rank.
"""

from __future__ import annotations

import datetime
import functools
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from freesurgs_tpu_torch.convert import field_from_numpy
from freesurgs_tpu_torch.core.camera import Camera
from freesurgs_tpu_torch.ops.render import render
from freesurgs_tpu_torch.parallel import dryrun
from freesurgs_tpu_torch.parallel import sharded
from freesurgs_tpu_torch.parallel.mesh import make_mesh, same_on_all_ranks
from freesurgs_tpu_torch.parallel.multiseq import (multiseq_mapping_chunk,
                                                   shard_states, stack_states)
from freesurgs_tpu_torch.parallel.sharded import (render_sharded,
                                                  render_sharded_full,
                                                  sharded_train_step)
from freesurgs_tpu_torch.train import steps
from freesurgs_tpu_torch.train.loop import Trainer
from freesurgs_tpu_torch.train.optim import adam_init
from freesurgs_tpu_torch.utils.logging import MetricsLogger

WORLD = 4
PARAM_KEYS = ("means", "quats", "log_scales", "logit_opacity", "sh")
FIELD_OUT = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
             "grad_accum", "grad_denom", "max_radii2d")
# the scenarios' configurations, shared with the test's JAX references
MAP_CFG = dict(max_instances=4096, densify_interval=10_000,
               w_local_pearson=0.0)
TRACK_CFG = dict(max_instances=4096, tracking_iters=4, tracking_gn_iters=0)
MULTISEQ_CFG = dict(max_instances=4096, densify_interval=10_000)
TRAINER_CFG = dict(tracking_iters=2, mapping_iters=2,
                   first_frame_mapping_iters=3, tracking_gn_iters=2,
                   densify_interval=10_000)
TRAINER_KW = dict(sh_degree_max=0, capacity=4096, global_chunk=2,
                  validation_every=0, panel_every=1, checkpoint_every=2)
TRAINER_GLOBAL = 4


def camera(a) -> Camera:
    h, w, fx, fy, cx, cy = (float(v) for v in a)
    return Camera(height=int(h), width=int(w), fx=fx, fy=fy, cx=cx, cy=cy)


def field_arrays(inp, prefix):
    return {k[len(prefix):]: inp[k] for k in inp.keys()
            if k.startswith(prefix)}


def mapping_state(arrays, t, h, w, seed=0) -> steps.MappingState:
    field = field_from_numpy(arrays, device="cpu", max_sh_degree=0)
    return steps.MappingState(
        field=field, opt=adam_init(field.param_dict()), iteration=0,
        generator=torch.Generator().manual_seed(seed),
        pred_depths=torch.zeros(t, h, w), pred_colors=torch.zeros(t, 3, h, w))


def render_grads(render_fn, inp, prefix) -> dict:
    """A render of the test's scene and the gradients of a weighted sum of
    its render, depth and T_final in the parameters, the probe and the
    pose."""
    p = {k: torch.tensor(inp[prefix + k], requires_grad=True)
         for k in PARAM_KEYS}
    probe = torch.zeros(p["means"].shape[0], 2, requires_grad=True)
    w2c = torch.eye(4, requires_grad=True)
    out = render_fn(*p.values(), w2c, camera(inp["cam"]), probe2d=probe,
                    max_instances=4096)
    loss = (torch.sum(out["render"] * torch.tensor(inp["w_rgb"]))
            + torch.sum(out["render_dep"] * torch.tensor(inp["w_dep"]))
            + torch.sum(out["final_T"] * torch.tensor(inp["w_T"])))
    grads = torch.autograd.grad(loss, list(p.values()) + [probe, w2c])
    res = {k: out[k] for k in ("render", "render_dep", "final_T", "radii",
                               "overflow", "num_instances",
                               "band_num_instances") if k in out}
    res.update({f"g_{k}": g for k, g in zip(PARAM_KEYS + ("probe", "w2c"),
                                            grads)})
    return res


def mapping_run(inp, mesh, grad_sum="direct"):
    """mapping_chunk: 3 single-view iterations on frame 0 of the mapping
    scene, from its perturbed field."""
    mcam = camera(inp["m_cam"])
    st = mapping_state(field_arrays(inp, "mf_"), 2, mcam.height, mcam.width)
    return steps.mapping_chunk(
        st, torch.tensor(inp["m_colors"]), torch.tensor(inp["m_monodeps"]),
        torch.tensor(inp["m_w2c"]), [0, 0, 0], [], mcam,
        steps.TrainConfig(**MAP_CFG, grad_sum=grad_sum), two_views=False,
        sh_degree=0, mesh=mesh)


def band_spy(out: dict):
    """Wrap ``parallel.sharded``'s ``rasterize`` and ``all_reduce_sum`` so
    that one render records this rank's band as it was rendered: the
    clipped records and opacity, the layout, and the band's own prefix
    sums beside their all-reduce. Returns the undo."""
    rasterize, reduce = sharded.rasterize, sharded.all_reduce_sum

    def spy_rasterize(proj, rgbz, opacity, cfg, bins=None, band_sum=None):
        res = rasterize(proj, rgbz, opacity, cfg, bins=bins,
                        band_sum=band_sum)
        out.update({k: v.detach() for k, v in proj._asdict().items()})
        b = res["bins"]
        out.update(opacity=opacity.detach(), gather_idx=b.gather_idx,
                   pre_rank=b.pre_rank, seg_lo=b.seg_lo, seg_hi=b.seg_hi,
                   overflow=b.overflow, height=np.int64(cfg.height),
                   width=np.int64(cfg.width))
        return res

    def spy_reduce(x, group):
        total = reduce(x, group)
        if x.dim() == 2 and x.shape[1] == 10:   # the bands' (n, 10) sums
            out.update(part=x.detach(), total=total.detach())
        return total

    sharded.rasterize, sharded.all_reduce_sum = spy_rasterize, spy_reduce

    def undo():
        sharded.rasterize, sharded.all_reduce_sum = rasterize, reduce
    return undo


def tracking_run(inp, mesh):
    """tracking_loop of frame 1 on the frozen perturbed field."""
    mcam = camera(inp["m_cam"])
    field = field_from_numpy(field_arrays(inp, "mf_"), device="cpu",
                             max_sh_degree=0)
    return steps.tracking_loop(
        field, torch.tensor(inp["m_q0"]), torch.tensor(inp["m_t0"]),
        torch.tensor(inp["m_colors"][1]), torch.tensor(inp["m_depth0"]),
        torch.tensor(inp["m_w2c"][0]), torch.tensor(inp["m_flow0"]),
        torch.ones(mcam.height, mcam.width), mcam,
        steps.TrainConfig(**TRACK_CFG), mesh=mesh)


def sequence_state(inp, i: int) -> steps.MappingState:
    scam = camera(inp["s_cam"])
    return mapping_state(field_arrays(inp, f"sf{i}_"), 2, scam.height,
                         scam.width, seed=i)


class Seq:
    def __init__(self, inp):
        self.cam = camera(inp["tr_cam"])
        self.colors = inp["tr_colors"]
        self.monodeps = inp["tr_monodeps"]
        self.flows_fw = inp["tr_flows"]
        self.i_train = np.arange(self.colors.shape[0])
        self.i_test = np.zeros(0, np.int64)


def trainer_run(mesh, inp, run_dir: Path, prefix: str) -> dict:
    """A Trainer (on ``mesh``, or one process with None): progressive stage
    and TRAINER_GLOBAL global iterations, with periodic checkpoints,
    metrics.jsonl and panels into ``run_dir`` (on a mesh, the directory
    every rank shares)."""
    panels = []
    tr = Trainer(Seq(inp), steps.TrainConfig(**TRAINER_CFG), mesh=mesh,
                 device="cpu", log_fn=lambda *a: None,
                 checkpoint_dir=str(run_dir),
                 metrics_logger=MetricsLogger(str(run_dir)),
                 panel_fn=lambda name, img, step: panels.append(name),
                 **TRAINER_KW)
    tr.progressive_run()
    tr.global_run(TRAINER_GLOBAL)
    tr.save(str(run_dir / "ckpt_final"))
    res = {k: getattr(tr.field, k) for k in FIELD_OUT}
    res.update(quats_pose=tr.poses.quats, trans=tr.poses.trans,
               history=np.int64(len(tr.history)),
               panels=np.int64(len(panels)))
    return {prefix + k: v for k, v in res.items()}


def scenarios(inp, out_dir: Path) -> dict:
    """Every collective scenario; the results but the multi-sequence ones
    are the same on every rank (``ranks_equal``)."""
    mesh4 = make_mesh(device="cpu")
    mesh22 = make_mesh(data_parallel=2, device="cpu")
    mesh41 = make_mesh(data_parallel=WORLD, device="cpu")
    res = {}
    for name, mesh, prefix, sp in (("b2", mesh22, "p_", False),
                                   ("b4", mesh4, "p_", False),
                                   ("sp", mesh4, "q_", True)):
        r = render_grads(functools.partial(render_sharded_full, mesh,
                                           shard_projection=sp), inp, prefix)
        res.update({f"{name}_{k}": v for k, v in r.items()})
        band = {}
        undo = band_spy(band) if name == "b2" else (lambda: None)
        try:
            r = render_grads(functools.partial(
                render_sharded_full, mesh, shard_projection=sp,
                grad_sum="prefix"), inp, prefix)
        finally:
            undo()
        res.update({f"p{name}_{k}": v for k, v in r.items()})
        if band:
            np.savez(out_dir / f"prefix_band{dist.get_rank()}.npz",
                     **{k: (v.numpy() if torch.is_tensor(v) else v)
                        for k, v in band.items()})

    cam = camera(inp["cam"])
    p = {k: torch.tensor(inp["p_" + k]) for k in PARAM_KEYS}
    out = render_sharded(mesh4, *p.values(), torch.eye(4), cam)
    res.update({f"rs_{k}": out[k] for k in ("render", "render_dep",
                                            "final_T")})
    losses = []
    for _ in range(3):
        p, loss = sharded_train_step(mesh4, p, torch.eye(4),
                                     torch.tensor(inp["target"]), cam,
                                     lr=5e-3)
        losses.append(loss)
    res["sts_loss"] = torch.stack(losses)
    res.update({f"sts_{k}": v for k, v in p.items()})

    st, aux = mapping_run(inp, mesh4)
    res.update({f"map_{k}": getattr(st.field, k) for k in FIELD_OUT})
    res["map_loss"] = aux["loss"]
    st, aux = mapping_run(inp, mesh4, grad_sum="prefix")
    res.update({f"pmap_{k}": getattr(st.field, k) for k in FIELD_OUT})
    res["pmap_loss"] = aux["loss"]
    q, t, met = tracking_run(inp, mesh22)
    res.update(trk_q=q, trk_t=t, trk_loss=met["loss"])

    res["dryrun"] = np.asarray(json.dumps(dryrun.run(mesh22)))
    res.update(trainer_run(mesh22, inp, out_dir / "trainer", "tr_"))
    shared = [v for v in res.values() if torch.is_tensor(v)]
    res["ranks_equal"] = np.bool_(same_on_all_ranks(shared))

    # four sequences, one per rank
    states = [sequence_state(inp, i) for i in range(WORLD)]
    st, aux = multiseq_mapping_chunk(
        mesh41, shard_states(mesh41, stack_states(states)),
        torch.tensor(inp["s_colors"]), torch.tensor(inp["s_monodeps"]),
        torch.tensor(inp["s_w2c"]), torch.zeros(WORLD, 4, dtype=torch.int64),
        camera(inp["s_cam"]), steps.TrainConfig(**MULTISEQ_CFG))
    res.update({f"ms_{k}": getattr(st.field, k) for k in FIELD_OUT})
    res["ms_loss"] = aux["loss"]
    res["ms_iteration"] = aux["iteration"]
    return res


def single_references(rank: int, inp, out_dir: Path) -> dict:
    """The port's single-process functions on the same inputs: the renders,
    mapping and tracking on rank 0, the Trainer on rank 1, and each rank's
    own sequence's mapping_chunk."""
    res = {}
    if rank == 0:
        for name, prefix in (("single_p", "p_"), ("single_q", "q_")):
            r = render_grads(render, inp, prefix)
            res.update({f"{name}_{k}": v for k, v in r.items()})
        st, _ = mapping_run(inp, None)
        res.update({f"single_map_{k}": getattr(st.field, k)
                    for k in FIELD_OUT})
        q, t, _ = tracking_run(inp, None)
        res.update(single_trk_q=q, single_trk_t=t)
    if rank == 1:
        res.update(trainer_run(None, inp, out_dir / "single", "single_tr_"))
    st, aux = steps.mapping_chunk(
        sequence_state(inp, rank), torch.tensor(inp["s_colors"][rank]),
        torch.tensor(inp["s_monodeps"][rank]),
        torch.tensor(inp["s_w2c"][rank]), [0] * 4, [],
        camera(inp["s_cam"]), steps.TrainConfig(**MULTISEQ_CFG),
        two_views=False, sh_degree=0)
    res.update({f"single_ms_{k}": getattr(st.field, k) for k in FIELD_OUT})
    res["single_ms_loss"] = aux["loss"]
    return res


def main(rank: int, init_file: str, in_path: str, out_dir: str) -> None:
    """One rank (``torch.multiprocessing`` passes ``rank`` first)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with np.load(in_path) as inp:
            res = scenarios(inp, Path(out_dir))
            res.update(single_references(rank, inp, Path(out_dir)))
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **{k: (v.detach().numpy() if torch.is_tensor(v) else v)
                    for k, v in res.items()})
    finally:
        dist.destroy_process_group()
