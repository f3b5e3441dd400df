"""PnP pose init: ``flow_matches`` and ``pnp_pose_init`` (``models/pose.py``)
with the port's RANSAC PnP solver (``models/pnp.py``) against the JAX
function, whose solve is ``cv2.solvePnPRansac`` (cv2 is importable here,
not on the card's machine); and ``Trainer(pose_init="pnp")``.

Tolerances: the JAX test's own gate (tests/test_pose_utils.py): the
recovered pose within 0.01 of the ground truth in translation (norm) and
in every rotation-matrix entry, for both solvers, on exact analytic flow
and with 30% of the flow vectors corrupted by up to 20 px. The two solvers
draw different minimal sets and refine differently (cv2: EPnP on 5 points
and Levenberg-Marquardt; the port: a 6-point DLT and Gauss-Newton), so
they agree within that gate, not bit for bit. The solver alone, on exact
float64 data, recovers the pose to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.data.synthetic import make_scene as jmake_scene
from freesurgs_tpu.models import pose as jpose
from freesurgs_tpu_torch.core.transforms import quat_to_rotmat
from freesurgs_tpu_torch.data.synthetic import SceneSequence, make_scene
from freesurgs_tpu_torch.models import pnp
from freesurgs_tpu_torch.models import pose as tpose
from freesurgs_tpu_torch.train import loop as tloop
from freesurgs_tpu_torch.train import steps as ts

from test_torch_train import tcam

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

POSE_TOL = 0.01


@pytest.fixture(scope="module")
def pnp_scene():
    """The JAX test's scene: make_scene(3, 300, 64, 80, seed=2)."""
    return jmake_scene(num_frames=3, n_gaussians=300, height=64, width=80,
                       seed=2)


def test_flow_matches_matches_jax():
    rng = np.random.default_rng(0)
    flow = rng.normal(scale=6.0, size=(2, 24, 32)).astype(np.float32)
    cam = _Cam(24, 32)
    j = jax.jit(jpose.flow_matches, static_argnums=1)(flow, cam)
    t = tpose.flow_matches(torch.tensor(flow), tcam(cam))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert 0 < int(t[2].sum()) < t[2].numel()


def _Cam(h, w):
    from freesurgs_tpu.core.camera import Camera
    return Camera(height=h, width=w, fx=w * 1.1, fy=w * 1.1, cx=w / 2,
                  cy=h / 2)


def _errors(w2c, gt):
    return (float(np.linalg.norm(w2c[:3, 3] - gt[:3, 3])),
            float(np.abs(w2c[:3, :3] - gt[:3, :3]).max()))


@pytest.mark.parametrize("corrupt", [0.0, 0.3])
def test_pnp_pose_init_vs_cv2(pnp_scene, corrupt):
    """Frame 1 from frame 0's depth and the 0 -> 1 flow, with frame 0 at
    its ground-truth pose, by the JAX function (cv2) and the port: both
    within POSE_TOL of the ground truth."""
    sc = pnp_scene
    flow = np.asarray(sc.flows_fw[0]).copy()
    if corrupt:
        rng = np.random.default_rng(1)
        bad = rng.random(flow.shape[1:]) < corrupt
        flow[:, bad] += rng.uniform(-20, 20, (2, int(bad.sum())))
    depth = np.asarray(sc.depths[0])
    w0 = np.asarray(sc.gt_w2c[0])
    gt = np.asarray(sc.gt_w2c[1])

    jp = jpose.identity_poses(3).set_frame(0, sc.gt_quats[0],
                                           sc.gt_trans[0])
    jp = jpose.pnp_pose_init(jp, 1, jnp.asarray(flow), jnp.asarray(depth),
                             jnp.asarray(w0), sc.cam)
    tp = tpose.identity_poses(3, "cpu").set_frame(
        0, torch.tensor(np.asarray(sc.gt_quats[0])),
        torch.tensor(np.asarray(sc.gt_trans[0])))
    tp = tpose.pnp_pose_init(tp, 1, torch.tensor(flow), torch.tensor(depth),
                             torch.tensor(w0), tcam(sc.cam))
    for w2c in (np.asarray(jp.w2c(1)), tp.w2c(1).numpy()):
        dt, dr = _errors(w2c, gt)
        assert dt < POSE_TOL and dr < POSE_TOL, (dt, dr)
    # frame 0 untouched, frame 2 not written
    assert torch.equal(tp.quats[2], torch.tensor([1.0, 0, 0, 0]))


def test_solver_exact_and_seeded():
    """Exact float64 matches under a known pose: recovered to 1e-9 with
    every match an inlier; the same seed gives the same result bit for
    bit; 20% outliers leave the pose exact and are flagged."""
    rng = np.random.default_rng(4)
    n = 500
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                  rng.uniform(1.0, 3.0, n)], 1)
    w = np.array([0.05, -0.03, 0.02])
    R = quat_to_rotmat(torch.tensor(np.r_[1.0, w / 2])
                       / np.linalg.norm(np.r_[1.0, w / 2])).numpy()
    t = np.array([0.03, -0.02, 0.05])
    K = np.array([[88.0, 0, 40.0], [0, 88.0, 32.0], [0, 0, 1.0]])
    pc = X @ R.T + t
    img = (pc[:, :2] / pc[:, 2:3]) * 88.0 + np.array([40.0, 32.0])
    out = rng.random(n) < 0.2
    img_bad = img.copy()
    img_bad[out] += rng.uniform(15, 40, (int(out.sum()), 2)) * \
        rng.choice([-1, 1], (int(out.sum()), 2))
    for im, inl in ((img, np.ones(n, bool)), (img_bad, ~out)):
        res = pnp.solve_pnp_ransac(torch.tensor(X), torch.tensor(im),
                                   torch.tensor(K), seed=3)
        assert res.ok
        np.testing.assert_allclose(res.R.numpy(), R, atol=1e-9)
        np.testing.assert_allclose(res.t.numpy(), t, atol=1e-9)
        np.testing.assert_array_equal(res.inliers.numpy(), inl)
        again = pnp.solve_pnp_ransac(torch.tensor(X), torch.tensor(im),
                                     torch.tensor(K), seed=3)
        assert torch.equal(again.R, res.R) and torch.equal(again.t, res.t)
    few = pnp.solve_pnp_ransac(torch.tensor(X[:5]), torch.tensor(img[:5]),
                               torch.tensor(K))
    assert not few.ok


def test_pnp_pose_init_copies_previous_without_matches(pnp_scene):
    """No valid depth (fewer than 6 usable matches): the previous pose is
    copied, as in the JAX function."""
    sc = pnp_scene
    tp = tpose.identity_poses(3, "cpu").set_frame(
        0, torch.tensor([0.9, 0.1, 0.0, 0.0]), torch.tensor([0.1, 0, 0]))
    out = tpose.pnp_pose_init(tp, 1, torch.tensor(np.asarray(sc.flows_fw[0])),
                              torch.zeros(64, 80), tp.w2c(0), tcam(sc.cam))
    assert torch.equal(out.quats[1], tp.quats[0])
    assert torch.equal(out.trans[1], tp.trans[0])


def test_trainer_pnp_init(monkeypatch):
    """A 4-frame Trainer(pose_init="pnp") at 32x48 calls pnp_pose_init for
    frames 2 and 3 with the JAX Trainer's arguments (the frame's flow from
    t-1, frame t-1's cached depth in f32, the pose of t-1, seed + t), and
    tracking starts from the pose it returns."""
    sc = make_scene(num_frames=4, n_gaussians=150, height=32, width=48,
                    seed=6, device="cpu")
    calls = []
    real = tpose.pnp_pose_init

    def spy(poses, t, flow, depth, prev_w2c, cam, **kw):
        new = real(poses, t, flow, depth, prev_w2c, cam, **kw)
        calls.append(dict(t=t, flow=flow.clone(), depth=depth.clone(),
                          prev_w2c=prev_w2c.clone(),
                          want_w2c=poses.w2c(t - 1).detach().clone(),
                          cam=cam, kw=kw, quat=new.quats[t].clone()))
        return new

    monkeypatch.setattr(tloop.posemod, "pnp_pose_init", spy)
    started = {}
    real_track = tloop.tracking_loop

    def track_spy(field, quat, trans, *a, **kw):
        started[len(started) + 1] = quat.detach().clone()
        return real_track(field, quat, trans, *a, **kw)

    monkeypatch.setattr(tloop, "tracking_loop", track_spy)
    cfg = ts.TrainConfig(tracking_iters=2, mapping_iters=2,
                         first_frame_mapping_iters=3)
    tr = tloop.Trainer(SceneSequence(sc), cfg, sh_degree_max=0,
                       capacity=4096, pose_init="pnp", seed=9, device="cpu",
                       log_fn=lambda *a: None)
    depths = []
    real_map = tr._map_frame

    def map_spy(t, *a, **kw):
        out = real_map(t, *a, **kw)
        depths.append(tr.state.pred_depths[t].clone())
        return out

    monkeypatch.setattr(tr, "_map_frame", map_spy)
    tr.progressive_run()
    assert [c["t"] for c in calls] == [2, 3]
    for c in calls:
        t = c["t"]
        assert torch.equal(c["flow"], tr.flows_fw[t - 1])
        assert c["depth"].dtype == torch.float32
        assert torch.equal(c["depth"], depths[t - 1].to(torch.float32))
        assert torch.equal(c["prev_w2c"], c["want_w2c"])
        assert c["cam"] == tr.cam and c["kw"] == {"seed": 9 + t}
        assert torch.equal(started[t], c["quat"])
    losses = [float(h["loss"]) for h in tr.history if "loss" in h]
    assert np.isfinite(losses).all()
