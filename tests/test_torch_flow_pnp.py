"""The GN flow-PnP tracking init (``train/flow_pnp.py``) against the JAX
package: ``so3_exp``, ``rotmat_to_quat``, ``flow_pnp_refine`` on exact
flow, noisy flow and an empty depth cache, and ``tracking_loop`` at the
default ``tracking_gn_iters=8`` (GN init, then Adam).

Tolerances. Both sides solve the same 6x6 normal equations, summed in f32
over 5,120 points in another order; the solve amplifies that noise by the
system's condition, and 8 GN steps compound it: poses to 1e-5, the mean
residual to 1e-3 relative (a mean of pixel-scale values), the effective
weight to 1e-4 relative. The tracking test holds poses at the slice's
tracking gate (1e-5) and losses at 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.transforms import rotmat_to_quat as jr2q
from freesurgs_tpu.data.synthetic import make_scene
from freesurgs_tpu.train import steps as js
from freesurgs_tpu.train.flow_pnp import flow_pnp_refine as jrefine
from freesurgs_tpu.train.flow_pnp import so3_exp as jso3
from freesurgs_tpu_torch.core.transforms import rotmat_to_quat as tr2q
from freesurgs_tpu_torch.train import steps as ts
from freesurgs_tpu_torch.train.flow_pnp import flow_pnp_refine as trefine
from freesurgs_tpu_torch.train.flow_pnp import so3_exp as tso3

from test_torch_train import scene, tcam  # noqa: F401  (fixture)

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("omega", [[0.0, 0.0, 0.0], [3e-5, -2e-5, 1e-5],
                                   [0.3, -0.2, 0.1]])
def test_so3_exp(omega):
    """Zero, the Taylor branch and a finite angle; the gradient stays
    finite at zero (the GN loop's fixed point)."""
    w = np.asarray(omega, np.float32)
    R = tso3(torch.tensor(w))
    np.testing.assert_allclose(np.asarray(jso3(jnp.asarray(w))), R.numpy(),
                               atol=1e-7)
    np.testing.assert_allclose(R.numpy() @ R.numpy().T, np.eye(3),
                               atol=1e-6)
    tw = torch.tensor(w, requires_grad=True)
    tso3(tw).sum().backward()
    assert torch.isfinite(tw.grad).all()


def test_rotmat_to_quat():
    """Random rotations, and angles near pi where the w-branch is
    ill-conditioned and another candidate is picked."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4))
    q[:8, 0] = 1e-3                           # near 180 degrees
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jr2q(jnp.asarray(R))),
                               tr2q(torch.tensor(R)).numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def gn_scene():
    return make_scene(num_frames=4, n_gaussians=400, height=64, width=80,
                      seed=3)


@pytest.mark.parametrize("case", ["exact", "noisy", "empty_depth"])
def test_flow_pnp_refine(gn_scene, case):
    sc = gn_scene
    t = 2
    rng = np.random.default_rng(0)
    depth = np.asarray(sc.depths[t - 1])
    flow = np.asarray(sc.flows_fw[t - 1])
    if case == "noisy":      # 0.5 px flow and 2% depth noise
        flow = (flow + rng.normal(size=flow.shape) * 0.5).astype(np.float32)
        depth = (depth * (1.0 + rng.normal(size=depth.shape) * 0.02)
                 ).astype(np.float32)
    elif case == "empty_depth":   # the cache of an unmapped frame
        depth = np.zeros_like(depth)
    q0 = np.asarray(sc.gt_quats[t - 1])
    t0 = np.asarray(sc.gt_trans[t - 1])
    prev = np.asarray(sc.gt_w2c[t - 1])
    rigid = np.ones((64, 80), np.float32)
    jq, jt, jd = jrefine(*map(jnp.asarray, (q0, t0, depth, prev, flow)),
                         sc.cam, rigid_mask=jnp.asarray(rigid), iters=8)
    tq, tt, td = trefine(*map(torch.tensor, (q0, t0, depth, prev, flow)),
                         tcam(sc.cam), rigid_mask=torch.tensor(rigid),
                         iters=8)
    np.testing.assert_allclose(np.asarray(jq), tq.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(jd[1]), float(td[1]), rtol=1e-4)
    if case == "empty_depth":
        assert float(td[1]) == 0.0            # the guard keeps the init
        np.testing.assert_allclose(tt.numpy(), t0, atol=1e-6)
        np.testing.assert_allclose(np.abs(tq.numpy()), np.abs(q0), atol=1e-6)
    else:
        np.testing.assert_allclose(float(jd[0]), float(td[0]), rtol=1e-3,
                                   atol=1e-6)
        # the solve moved the pose most of the way to the truth
        gt_t = np.asarray(sc.gt_trans[t])
        assert (np.linalg.norm(tt.numpy() - gt_t)
                < 0.25 * np.linalg.norm(t0 - gt_t))


def test_tracking_loop_default_gn(scene):  # noqa: F811
    """tracking_loop at the JAX default tracking_gn_iters=8: the GN init,
    then the Adam loop, with the GN diagnostics under the JAX names.

    The flow carries 0.5 px of noise. With exact flow on this perfect map
    GN lands on the optimum of both loss terms, where the gradient Adam
    normalizes is rounding noise whose sign differs between the packages
    (2e-5 apart after two steps); off the optimum both follow the same
    gradient."""
    sc, jf, tf = scene
    kw = dict(tracking_iters=6)
    assert ts.TrainConfig().tracking_gn_iters == 8
    q0 = np.asarray(sc.gt_quats[0])
    t0 = np.asarray(sc.gt_trans[0])
    noise = np.random.default_rng(1).normal(size=(2, 64, 80)) * 0.5
    inputs = (np.asarray(sc.colors[1]), np.asarray(sc.depths[0]),
              np.asarray(sc.gt_w2c[0]),
              (np.asarray(sc.flows_fw[0]) + noise).astype(np.float32),
              np.ones((64, 80), np.float32))
    jq, jt, jm = js.tracking_loop(
        jf, jnp.asarray(q0), jnp.asarray(t0), *map(jnp.asarray, inputs),
        sc.cam, js.TrainConfig(impl="oracle", **kw), sh_degree=1)
    tq, tt, tm = ts.tracking_loop(
        tf, torch.tensor(q0), torch.tensor(t0),
        *(torch.tensor(x) for x in inputs), tcam(sc.cam),
        ts.TrainConfig(**kw), sh_degree=1)
    assert float(tm["gn_weight"]) >= 64        # GN ran, not the guard
    for k in ("gn_weight", "gn_resid_px", "loss", "flow_loss"):
        np.testing.assert_allclose(float(jm[k]), float(tm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.asarray(jq), tq.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5)
    assert float(tm["nonfinite_grads"]) == 0
