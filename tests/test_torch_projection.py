"""freesurgs_tpu_torch.ops.projection against freesurgs_tpu.ops.projection:
outputs of ``project_gaussians`` and autograd vs ``jax.grad`` for means,
scales, quats and the pose.

Tolerances: the forward is the same f32 arithmetic (atol 1e-5 on pixel
coordinates of magnitude ~1e2, rtol 1e-5 on conics); integer fields
(radius, rects) must be equal. Gradients are compared normalized by the
largest magnitude per tensor at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.core.transforms import build_w2c as jbuild, \
    transform_points as jtp
from freesurgs_tpu.ops.projection import build_cov3d as jcov, \
    project_gaussians as jproj
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.core.transforms import build_w2c as tbuild, \
    transform_points as ttp
from freesurgs_tpu_torch.ops.projection import build_cov3d as tcov, \
    project_gaussians as tproj

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

KW = dict(height=40, width=56, fx=50.0, fy=52.0, cx=28.0, cy=20.0)


def scene(n=200, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(0.1, 3.0, n)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-4.0, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    return means, scales, quats, active


def norm_close(a, b, tol=1e-5):
    a = np.asarray(a)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    scale = max(np.abs(a).max(), 1e-12)
    np.testing.assert_allclose(a / scale, b / scale, atol=tol)


def test_build_cov3d():
    means, scales, quats, _ = scene(50)
    np.testing.assert_allclose(
        np.asarray(jcov(jnp.asarray(scales), jnp.asarray(quats))),
        tcov(torch.tensor(scales), torch.tensor(quats)).numpy(),
        atol=1e-9, rtol=1e-5)


def test_project_gaussians_outputs():
    means, scales, quats, active = scene()
    j = jproj(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
              JCam(**KW), active=jnp.asarray(active))
    t = tproj(torch.tensor(means), torch.tensor(scales), torch.tensor(quats),
              TCam(**KW), active=torch.tensor(active))
    vis = np.asarray(j.radius) > 0
    assert 20 < vis.sum() < len(vis)    # some culled (z <= 0.2, inactive)
    np.testing.assert_allclose(np.asarray(j.mean2d), t.mean2d.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(j.conic)[vis], t.conic.numpy()[vis],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(j.depth), t.depth.numpy())
    for name in ("radius", "tile_rect", "tiles_touched"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy())


def test_projection_gradients_incl_pose():
    """Autograd through world->camera + EWA == jax.grad, pose included."""
    means, scales, quats, _ = scene(seed=1)
    q0 = np.asarray([0.98, 0.05, -0.1, 0.08], np.float32)
    t0 = np.asarray([0.05, -0.03, 0.1], np.float32)
    rng = np.random.default_rng(5)
    w1 = rng.normal(size=(len(means), 2)).astype(np.float32)
    w2 = rng.normal(size=(len(means), 3)).astype(np.float32)
    vis = np.asarray(jproj(jnp.asarray(means), jnp.asarray(scales),
                           jnp.asarray(quats), JCam(**KW)).radius) > 0
    vis_f = vis.astype(np.float32)[:, None]

    def jloss(m, s, q, qq, tt):
        p = jproj(jtp(jbuild(qq, tt), m), s, q, JCam(**KW))
        return (jnp.sum(p.mean2d * w1 * vis_f) + jnp.sum(p.conic * w2 * vis_f)
                + jnp.sum(p.depth * w1[:, 0]))

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (means, scales, quats, q0, t0)))
    ts = [torch.tensor(x, requires_grad=True)
          for x in (means, scales, quats, q0, t0)]
    p = tproj(ttp(tbuild(ts[3], ts[4]), ts[0]), ts[1], ts[2], TCam(**KW))
    vt = torch.tensor(vis_f)
    loss = ((p.mean2d * torch.tensor(w1) * vt).sum()
            + (p.conic * torch.tensor(w2) * vt).sum()
            + (p.depth * torch.tensor(w1[:, 0])).sum())
    loss.backward()
    for a, b in zip(gj, ts):
        norm_close(a, b.grad)
