"""The whole training job against the JAX Trainer: ``progressive_run`` with
the default GN tracking, then ``global_run`` in two calls (chunks, the
cross-call cadences, a validation mid-run, the opacity reset), then
``validation``; and the port's checkpoints: save, restore into a fresh
Trainer of another capacity, and the global counter carried across.

The scene has 3 frames at 32x48, frame 2 a test frame (tracked and cached,
never mapped). Local Pearson and densify draw random numbers the two
packages make differently, so they are off; everything else runs at the
JAX defaults. The JAX side renders with the dense oracle.

Tolerances: the Trainer gate of tests/test_torch_train.py (parameters 1e-3
at worst, 99% of entries 1e-5; poses 1e-5; losses 1e-4 relative). Image
metrics follow from renders that agree to ~1e-5: PSNR to 1e-3 dB, SSIM to
1e-5, random-feature LPIPS to 1e-4 relative (convolutions summed in
another order); ATE / RPE to 1e-5 like the poses (RPE rotation, in
degrees, to 1e-3).
"""

import numpy as np
import pytest
import torch

from freesurgs_tpu.data.synthetic import make_scene
from freesurgs_tpu.train import steps as js
from freesurgs_tpu.train.densify import DensifyConfig
from freesurgs_tpu.train.loop import Trainer as JTrainer
from freesurgs_tpu_torch.io.checkpoint import (latest_checkpoint,
                                               load_checkpoint_meta)
from freesurgs_tpu_torch.train import steps as ts
from freesurgs_tpu_torch.train.loop import Trainer as TTrainer
from freesurgs_tpu_torch.utils.logging import MetricsLogger

from test_torch_train import PARAMS, close_params, tcam

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

KW = dict(tracking_iters=4, mapping_iters=3, first_frame_mapping_iters=6,
          w_local_pearson=0.0, densify_interval=10_000,
          opacity_reset_interval=13, sh_increase_interval=8)
TRAINER_KW = dict(sh_degree_max=1, capacity=4096, global_chunk=4,
                  validation_every=8, log_fn=lambda *a: None)


class Panels(list):
    """A ``panel_fn`` that keeps (name, step, panel) in order."""

    def __call__(self, name, img, step):
        self.append((name, int(step), np.asarray(img)))


class Seq:
    def __init__(self, sc, cam):
        self.cam = cam
        self.colors = np.asarray(sc.colors)
        self.monodeps = np.asarray(sc.monodeps)
        self.flows_fw = np.asarray(sc.flows_fw)
        self.i_train = np.asarray([0, 1])
        self.i_test = np.asarray([2])
        self.gt_poses = {"k0": np.asarray(sc.gt_w2c)}
        self.boundaries = [0, 3]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sc = make_scene(num_frames=3, n_gaussians=300, height=32, width=48,
                    seed=5)
    jtr = JTrainer(Seq(sc, sc.cam),
                   js.TrainConfig(impl="oracle", max_instances=16384,
                                  densify=DensifyConfig(), **KW),
                   panel_fn=Panels(), panel_every=1, **TRAINER_KW)
    jtr.progressive_run()
    jtr.global_run(8)
    jtr.global_run(4)
    out = tmp_path_factory.mktemp("run")
    logger = MetricsLogger(str(out))
    ttr = TTrainer(Seq(sc, tcam(sc.cam)), ts.TrainConfig(**KW),
                   checkpoint_dir=str(out), checkpoint_every=8,
                   metrics_logger=logger, device="cpu", panel_fn=Panels(),
                   panel_every=1, **TRAINER_KW)
    ttr.progressive_run()
    ttr.global_run(8)
    ttr.global_run(4)
    logger.close()
    return sc, jtr, ttr, out


def test_progressive_and_global_match_jax(runs):
    sc, jtr, ttr, _ = runs
    assert ttr.cfg.tracking_gn_iters == 8          # the JAX default
    prog = [h for h in ttr.history if h["stage"] == "progressive"]
    # GN ran on both tracked frames; at 32 px high the 20 px edge mask
    # leaves it no point, so its guard kept the init (the solve itself is
    # held to JAX in tests/test_torch_flow_pnp.py)
    assert [float(h["gn_weight"]) for h in prog[1:]] == [0.0, 0.0]
    assert ttr.keyframes == jtr.keyframes == [0, 1]
    assert ttr.state.iteration == int(jtr.state.iteration) == 9 + 12
    assert ttr._global_done == jtr._global_done == 12
    assert ttr.active_sh_degree == jtr.active_sh_degree == 1
    jg = [h for h in jtr.history if h["stage"] == "global"]
    tg = [h for h in ttr.history if h["stage"] == "global"]
    # the port logs the cross-call total; JAX logs the per-call count
    assert [h["iter"] for h in tg] == [4, 8, 12]
    assert [h["iter"] for h in jg] == [4, 8, 4]
    for jh, th in zip(jg, tg):
        np.testing.assert_allclose(jh["loss"], th["loss"], rtol=1e-4)
        assert jh["num_active"] == th["num_active"]
        assert th["overflow"] == 0
    for jh, th in zip(jtr.history, ttr.history):
        if jh["stage"] == "progressive":
            for k in ("loss", "rgb_loss", "flow_loss", "gn_weight",
                      "gn_resid_px"):
                if k in jh:
                    np.testing.assert_allclose(float(jh[k]), float(th[k]),
                                               rtol=1e-4, atol=1e-6,
                                               err_msg=k)
    np.testing.assert_allclose(np.asarray(jtr.poses.quats),
                               ttr.poses.quats.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jtr.poses.trans),
                               ttr.poses.trans.numpy(), atol=1e-5)
    for k in PARAMS:
        close_params(getattr(jtr.field, k), getattr(ttr.field, k), k,
                     atol=1e-3)
    # the opacity reset at iteration 13 (in the global stage) fired on both
    assert float(ttr.field.logit_opacity[ttr.field.active].max()) < -4.0


def test_validation_matches_jax(runs):
    """The mid-run validation row (total 8) and a final call."""
    sc, jtr, ttr, _ = runs
    jv = [h for h in jtr.history if h["stage"] == "global_val"]
    tv = [h for h in ttr.history if h["stage"] == "global_val"]
    assert [h["iter"] for h in jv] == [h["iter"] for h in tv] == [8]
    final = (jtr.validation(), ttr.validation())
    for j, t in ((jv[0], tv[0]), final):
        np.testing.assert_allclose(j["psnr"], t["psnr"], atol=1e-3)
        np.testing.assert_allclose(j["ssim"], t["ssim"], atol=1e-5)
        np.testing.assert_allclose(j["lpips"], t["lpips"], rtol=1e-4)
        for k in ("ate", "rpe_trans"):
            np.testing.assert_allclose(j[k], t[k], atol=1e-5, err_msg=k)
        # 1e-5 in the poses is ~6e-4 degrees
        np.testing.assert_allclose(j["rpe_rot_deg"], t["rpe_rot_deg"],
                                   atol=1e-3)
    assert final[1]["lpips_backend"] == final[0]["lpips_backend"] \
        == "random_features"
    assert final[1]["overflow"] == 0


def test_panels_match_jax(runs):
    """With panel_every=1 both Trainers hand panel_fn the same panels: a
    compare panel per mapped frame, a val panel per validated test view, at
    the same iterations and shapes; pixels to 1e-4."""
    _, jtr, ttr, _ = runs
    jp, tp = jtr.panel_fn, ttr.panel_fn
    assert [(n, s) for n, s, _ in tp] == [(n, s) for n, s, _ in jp]
    assert [n for n, _, _ in tp][:3] == ["compare_f0000", "compare_f0001",
                                         "val_f0002"]
    assert [s for _, s, _ in tp][:3] == [6, 9, 17]
    for (name, _, j), (_, _, t) in zip(jp, tp):
        assert j.shape == t.shape and t.dtype == np.float32, name
        np.testing.assert_allclose(j, t, atol=1e-4, err_msg=name)
    # frame 2, the last, has no flow: four parts, not five
    assert tp[2][2].shape[1] < tp[1][2].shape[1]


def test_periodic_checkpoints_and_metrics_log(runs):
    _, _, ttr, out = runs
    assert latest_checkpoint(str(out)) == str(out / "ckpt_0000008")
    meta = load_checkpoint_meta(str(out / "ckpt_0000008"))
    assert meta["global_done"] == 8 and meta["capacity"] == 4096
    rows = (out / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == len(ttr.history)


def _state_tensors(tr):
    st = tr.state
    out = {k: getattr(st.field, k) for k in PARAMS + (
        "active", "max_radii2d", "grad_accum", "grad_denom", "scene_radius")}
    out.update({f"mu.{k}": v for k, v in st.opt.mu.items()})
    out.update({f"nu.{k}": v for k, v in st.opt.nu.items()})
    out.update(pred_depths=st.pred_depths, pred_colors=st.pred_colors,
               quats=tr.poses.quats, trans=tr.poses.trans,
               generator=st.generator.get_state())
    return out


@pytest.mark.parametrize("capacity", [2048, 8192])
def test_restore_into_fresh_trainer(runs, tmp_path, capacity):
    """save, then restore into a Trainer built with another capacity (the
    restore shrinks or grows it to the checkpoint's first): every state
    tensor, the counters and a render are equal."""
    sc, _, ttr, _ = runs
    ttr.save(str(tmp_path / "ckpt_final"))
    fresh = TTrainer(Seq(sc, tcam(sc.cam)), ts.TrainConfig(**KW),
                     device="cpu", **{**TRAINER_KW, "capacity": capacity})
    assert fresh.field.capacity == capacity
    fresh.restore(str(tmp_path / "ckpt_final"))
    assert fresh.field.capacity == ttr.field.capacity
    a, b = _state_tensors(ttr), _state_tensors(fresh)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert fresh.state.opt.count == ttr.state.opt.count
    assert fresh.state.iteration == ttr.state.iteration
    assert fresh.keyframes == ttr.keyframes
    assert fresh.active_sh_degree == ttr.active_sh_degree
    assert fresh._global_done == 12
    assert torch.equal(fresh.render_frame(0)["render"],
                       ttr.render_frame(0)["render"])


def test_global_counter_continues_after_restore(runs, tmp_path):
    """A restored Trainer's global stage counts on from the checkpoint's
    total: cadences, checkpoint names and history rows."""
    sc, _, ttr, _ = runs
    ttr.save(str(tmp_path / "ckpt_0000012"))
    fresh = TTrainer(Seq(sc, tcam(sc.cam)), ts.TrainConfig(**KW),
                     device="cpu", checkpoint_dir=str(tmp_path),
                     checkpoint_every=8, **TRAINER_KW)
    fresh.restore(latest_checkpoint(str(tmp_path)))
    fresh.global_run(4)
    assert fresh._global_done == 16
    assert fresh.state.iteration == ttr.state.iteration + 4
    assert [h["iter"] for h in fresh.history] == [16, 16]  # global, val
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_0000016")


@pytest.mark.parametrize("cache", [True, False])
def test_cache_test_frames(cache):
    """An unmapped test frame is rendered into the caches (the default), so
    the next frame's GN solve has a depth to reproject; without the render
    the cache stays empty and GN's guard keeps the init (the reference's
    behaviour). 48x64, where GN has points inside the 20 px edge mask."""
    from freesurgs_tpu_torch.data.synthetic import SceneSequence
    from freesurgs_tpu_torch.data.synthetic import make_scene as tmake
    sc = tmake(num_frames=3, n_gaussians=300, height=48, width=64, seed=5,
               device="cpu")
    cfg = ts.TrainConfig(tracking_iters=2, mapping_iters=2,
                         first_frame_mapping_iters=3)
    tr = TTrainer(SceneSequence(sc, i_test=[1]), cfg, sh_degree_max=0,
                  capacity=4096, cache_test_frames=cache, device="cpu",
                  log_fn=lambda *a: None)
    tr.progressive_run()
    assert bool((tr.state.pred_depths[1] != 0).any()) == cache
    gn_weight = float(tr.history[2]["gn_weight"])
    assert (gn_weight >= 64) == cache, gn_weight


@pytest.mark.parametrize("kw,exc,match", [
    ({"mesh": object()}, TypeError, "mesh"),
    ({"pose_init": "sfm"}, ValueError, "pose_init='sfm'")])
def test_features_of_later_slices_raise(kw, exc, match):
    """A ``mesh`` that is not a ``parallel.mesh.Mesh`` (the JAX Trainer's
    takes a jax Mesh) raises a TypeError naming it instead of training on
    one device; an unknown pose init raises, naming it, instead of falling
    back to constant velocity. (The viewer, refused here until it was
    ported, is tests/test_torch_viz.py's; the mesh on several ranks is
    tests/test_torch_parallel.py's.)"""
    sc = make_scene(num_frames=3, n_gaussians=50, height=32, width=48,
                    seed=1)
    with pytest.raises(exc, match=match):
        TTrainer(Seq(sc, tcam(sc.cam)), ts.TrainConfig(), device="cpu",
                 **kw)


def test_single_rank_mesh_trainer_is_bitwise_the_plain_one():
    """A Trainer on the one-rank CPU mesh of ``make_mesh()`` (no process
    group: one band, no collective) runs 2 frames and a global chunk
    through the band-sharded render and ends bitwise where the Trainer
    without a mesh does."""
    from freesurgs_tpu_torch.data.synthetic import SceneSequence
    from freesurgs_tpu_torch.data.synthetic import make_scene as tmake
    from freesurgs_tpu_torch.parallel.mesh import make_mesh
    sc = tmake(num_frames=2, n_gaussians=150, height=32, width=48, seed=2,
               device="cpu")
    cfg = ts.TrainConfig(tracking_iters=2, mapping_iters=2,
                         first_frame_mapping_iters=3, tracking_gn_iters=2)
    runs = []
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny tensors; the suite runs workers
    try:
        for mesh in (None, make_mesh(device="cpu")):
            tr = TTrainer(SceneSequence(sc), cfg, mesh=mesh, sh_degree_max=0,
                          capacity=4096, global_chunk=2, validation_every=0,
                          device="cpu", log_fn=lambda *a: None)
            tr.progressive_run()
            tr.global_run(2)
            runs.append(tr)
    finally:
        torch.set_num_threads(n_threads)
    a, b = runs
    for k in PARAMS + ("grad_accum", "grad_denom", "max_radii2d"):
        assert torch.equal(getattr(a.field, k), getattr(b.field, k)), k
    assert torch.equal(a.poses.quats, b.poses.quats)
    assert torch.equal(a.poses.trans, b.poses.trans)


def test_overflow_at_the_cap_is_logged():
    """A render that drops instances at ``max_instances_cap`` is logged
    with the JAX Trainer's warning, for a progressive frame, a global
    chunk and a validation (here the cap, one CHUNK, is below the two
    tiles' padded runs of every render)."""
    sc = make_scene(num_frames=3, n_gaussians=50, height=32, width=48,
                    seed=1)
    logs = []
    cfg = ts.TrainConfig(tracking_iters=1, mapping_iters=1,
                         first_frame_mapping_iters=1, tracking_gn_iters=0,
                         densify_interval=10_000, max_instances_cap=128)
    tr = TTrainer(Seq(sc, tcam(sc.cam)), cfg, sh_degree_max=0,
                  capacity=4096, global_chunk=2, validation_every=0,
                  device="cpu", log_fn=logs.append)
    tr.progressive_run()
    tr.global_run(2)
    tr.validation()
    warns = [s for s in logs if s.startswith("WARNING: instance overflow")]
    for where in ("frame 0", "frame 2", "global 2", "validation"):
        assert any(f"({where})" in s for s in warns), (where, warns)
    assert all("at the max_instances cap 128" in s
               and "suffix tiles render EMPTY" in s for s in warns)
