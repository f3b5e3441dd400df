"""Pose-only refinement against a frozen map (``eval/pose_refine.py``)
against the JAX package (oracle render) at 32x48, and the Trainer's
global-stage pose-BA pass (``pose_ba_every``).

The refined frame starts from its ground-truth pose moved by ~0.03 in
translation and ~2 degrees in rotation, so the photometric gradient is far
above rounding noise (where it is noise, Adam turns its sign into a full
step: ROADMAP Queue 3). Tolerances: poses 1e-5, best losses 1e-4
relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.data.synthetic import make_scene
from freesurgs_tpu.eval import pose_refine as jpr
from freesurgs_tpu.models.gaussians import GaussianField as JField
from freesurgs_tpu_torch.convert import field_from_numpy
from freesurgs_tpu_torch.eval import pose_refine as tpr
from freesurgs_tpu_torch.ops.render import render as trender
from freesurgs_tpu_torch.train import losses as tlosses
from freesurgs_tpu_torch.train import steps as ts
from freesurgs_tpu_torch.train.loop import Trainer

from test_torch_train import tcam

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

Q_OFF = np.asarray([0.9998, 0.012, -0.008, 0.01], np.float32)
T_OFF = np.asarray([0.03, -0.02, 0.015], np.float32)


@pytest.fixture(scope="module")
def scene():
    sc = make_scene(num_frames=3, n_gaussians=300, height=32, width=48,
                    seed=5)
    n, cap = 300, 384

    def pad(x):
        x = np.asarray(x)
        out = np.zeros((cap,) + x.shape[1:], x.dtype)
        out[:n] = x
        return out

    quats = pad(sc.quats)
    quats[n:, 0] = 1.0
    arrays = dict(means=pad(sc.means), quats=quats,
                  log_scales=pad(sc.log_scales),
                  logit_opacity=pad(sc.logit_opacity), sh_dc=pad(sc.sh),
                  sh_rest=np.zeros((cap, 0, 3), np.float32),
                  active=np.arange(cap) < n,
                  max_radii2d=np.zeros(cap, np.float32),
                  grad_accum=np.zeros(cap, np.float32),
                  grad_denom=np.zeros(cap, np.float32),
                  scene_radius=np.float32(1.0))
    jf = JField(**{k: jnp.asarray(v) for k, v in arrays.items()},
                max_sh_degree=0)
    tf = field_from_numpy(arrays, device="cpu", max_sh_degree=0)
    quats0 = np.asarray(sc.gt_quats).copy()
    trans0 = np.asarray(sc.gt_trans).copy()
    quats0[1:] = quats0[1:] + Q_OFF - np.asarray([1, 0, 0, 0], np.float32)
    trans0[1:] = trans0[1:] + T_OFF
    return sc, jf, tf, quats0, trans0


def _loss_at(tf, q, t, gt, cam):
    from freesurgs_tpu_torch.core.transforms import build_w2c
    with torch.no_grad():
        out = trender(tf.means, tf.quats, tf.log_scales, tf.logit_opacity,
                      tf.sh, build_w2c(q, t), cam, active=tf.active,
                      gs_grad=False)
        return float(tlosses.rgb_loss(out["render"], gt))


def test_refine_pose_matches_jax(scene):
    sc, jf, tf, quats0, trans0 = scene
    kw = dict(iters=6, lr=3e-3)
    jq, jt, jl = jpr.refine_pose(jf, jnp.asarray(quats0[1]),
                                 jnp.asarray(trans0[1]), sc.colors[1],
                                 sc.cam, impl="oracle", **kw)
    tq, tt, tl, ov, tl0 = tpr.refine_pose(
        tf, torch.tensor(quats0[1]), torch.tensor(trans0[1]),
        torch.tensor(np.asarray(sc.colors[1])), tcam(sc.cam), **kw)
    init = _loss_at(tf, torch.tensor(quats0[1]), torch.tensor(trans0[1]),
                    torch.tensor(np.asarray(sc.colors[1])), tcam(sc.cam))
    assert float(tl0) == init                      # the start pose's loss
    assert float(tl) < init - 1e-3                 # it did refine
    np.testing.assert_allclose(np.asarray(jq), tq.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(jl), float(tl), rtol=1e-4)
    assert float(ov) == 0


def test_refine_poses_scan_matches_jax(scene):
    """Frames 1 and 2 refined one after another; frame 0 untouched."""
    sc, jf, tf, quats0, trans0 = scene
    kw = dict(iters=4, lr=2e-3)
    jq, jt, jl = jpr.refine_poses_scan(
        jf, jnp.asarray(quats0), jnp.asarray(trans0), sc.colors,
        jnp.asarray([1, 2]), sc.cam, impl="oracle", **kw)
    q_in, t_in = torch.tensor(quats0), torch.tensor(trans0)
    colors = torch.tensor(np.asarray(sc.colors))
    tq, tt, tl, _, tl0 = tpr.refine_poses_scan(
        tf, q_in, t_in, colors, [1, 2], tcam(sc.cam), **kw)
    np.testing.assert_allclose(np.asarray(jq), tq.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4)
    assert torch.equal(tq[0], q_in[0]) and torch.equal(tt[0], t_in[0])
    assert torch.equal(q_in, torch.tensor(quats0))   # inputs not written
    # each frame's start loss, at the pose it was handed
    assert tl0.tolist() == [_loss_at(tf, q_in[t], t_in[t], colors[t],
                                     tcam(sc.cam)) for t in (1, 2)]
    assert bool((tl <= tl0).all())


def test_refine_pose_is_monotone(scene):
    """A learning rate that throws every step off: the best of the poses
    evaluated is the initial one, returned bitwise with its loss."""
    sc, _, tf, quats0, trans0 = scene
    q0, t0 = torch.tensor(quats0[1]), torch.tensor(trans0[1])
    gt = torch.tensor(np.asarray(sc.colors[1]))
    tq, tt, tl, _, tl0 = tpr.refine_pose(tf, q0, t0, gt, tcam(sc.cam),
                                         iters=4, lr=0.5)
    assert torch.equal(tq, q0) and torch.equal(tt, t0)
    assert float(tl) == float(tl0) == _loss_at(tf, q0, t0, gt, tcam(sc.cam))


# ------------------------------------------------------- the Trainer pass

CFG = dict(tracking_iters=2, mapping_iters=2, first_frame_mapping_iters=4,
           w_local_pearson=0.0, densify_interval=10_000,
           opacity_reset_interval=10_000)


def _trainer(sc, **kw):
    from freesurgs_tpu_torch.data.synthetic import SceneSequence
    return Trainer(SceneSequence(sc, i_test=[2]), ts.TrainConfig(**CFG),
                   sh_degree_max=0, capacity=1024, global_chunk=5,
                   validation_every=0, pose_ba_every=5, pose_ba_iters=3,
                   log_fn=lambda *a: None, device="cpu", **kw)


@pytest.fixture(scope="module")
def ba_runs(tmp_path_factory):
    """A: progressive, global_run(5) (BA and a checkpoint at 5), then
    global_run(5) (BA at 10). B: the same in one global_run(10) call."""
    from freesurgs_tpu_torch.data.synthetic import make_scene as tmake
    sc = tmake(num_frames=4, n_gaussians=300, height=32, width=48, seed=6,
               device="cpu")
    out = tmp_path_factory.mktemp("ba")
    a = _trainer(sc, checkpoint_dir=str(out), checkpoint_every=5)
    a.progressive_run()
    before = (a.poses.quats.clone(), a.poses.trans.clone())
    a.global_run(5)
    at5 = (a.poses.quats.clone(), a.poses.trans.clone())
    a.global_run(5)
    b = _trainer(sc)
    b.progressive_run()
    b.global_run(10)
    return sc, a, b, before, at5, out


def test_trainer_pose_ba_rows_and_pinned_frames(ba_runs):
    sc, a, _, before, at5, _ = ba_runs
    rows = [h for h in a.history if h["stage"] == "pose_ba"]
    assert [h["iter"] for h in rows] == [5, 10]
    assert all(np.isfinite(h["mean_loss"]) and h["overflow"] == 0
               for h in rows)
    # the monotone guard, and the pass's own clock
    assert all(h["mean_loss"] <= h["start_mean_loss"] and h["seconds"] >= 0
               for h in rows)
    for t in (0, 2):                   # frame 0 pinned, test frame 2
        assert torch.equal(a.poses.quats[t], before[0][t])
        assert torch.equal(a.poses.trans[t], before[1][t])
    moved = [t for t in (1, 3) if not torch.equal(at5[1][t], before[1][t])]
    assert moved, "no train pose was refined"


def test_trainer_pose_ba_checkpoint_holds_refined_poses(ba_runs):
    """The checkpoint of a BA chunk is written after the pass."""
    sc, _, _, _, at5, out = ba_runs
    fresh = _trainer(sc)
    fresh.restore(str(out / "ckpt_0000005"))
    assert torch.equal(fresh.poses.quats, at5[0])
    assert torch.equal(fresh.poses.trans, at5[1])


def test_trainer_pose_ba_refreshes_mapping_poses(ba_runs):
    """The chunk after a pass maps with the refined poses: one
    global_run(10) equals two global_run(5) calls (each call reads the
    poses afresh) bit for bit."""
    _, a, b, _, _, _ = ba_runs
    assert torch.equal(a.poses.quats, b.poses.quats)
    for k in ("means", "quats", "log_scales", "logit_opacity", "sh_dc"):
        assert torch.equal(getattr(a.field, k), getattr(b.field, k)), k
