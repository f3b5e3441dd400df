"""freesurgs_tpu_torch.core against freesurgs_tpu.core: camera, SE(3)
transforms and spherical harmonics on the same seeded numpy inputs.

Tolerance: the two sides evaluate the same f32 formulas, so they agree to
a few ulps; atol 1e-6 / rtol 1e-5 leaves room for XLA's fused reordering.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core import camera as jcam
from freesurgs_tpu.core import sh as jsh
from freesurgs_tpu.core import transforms as jtf
from freesurgs_tpu_torch.core import camera as tcam
from freesurgs_tpu_torch.core import sh as tsh
from freesurgs_tpu_torch.core import transforms as ttf

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-5)


def close(j, t, **kw):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(),
                               **{**TOL, **kw})


def test_camera_grid_backproject_project():
    rng = np.random.default_rng(0)
    H, W = 12, 17
    kw = dict(height=H, width=W, fx=20.0, fy=21.0, cx=8.5, cy=6.0)
    jc, tc = jcam.Camera(**kw), tcam.Camera(**kw)
    assert jc.tan_fov_x == tc.tan_fov_x and jc.tan_fov_y == tc.tan_fov_y
    np.testing.assert_array_equal(jc.intrinsic_matrix(),
                                  tc.intrinsic_matrix())
    jx, jy = jcam.pixel_grid(H, W)
    tx, ty = tcam.pixel_grid(H, W)
    close(jx, tx, atol=0)
    close(jy, ty, atol=0)
    depth = rng.uniform(0.5, 2.0, (H, W)).astype(np.float32)
    c2w = np.asarray(jtf.build_w2c(jnp.asarray([0.9, 0.1, -0.2, 0.05]),
                                   jnp.asarray([0.1, -0.2, 0.3])))
    close(jcam.backproject(jnp.asarray(depth), jc, jnp.asarray(c2w)),
          tcam.backproject(torch.tensor(depth), tc, torch.tensor(c2w)))
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    jp, jz = jcam.project(jnp.asarray(pts), jc)
    tp, tz = tcam.project(torch.tensor(pts), tc)
    close(jp, tp)
    close(jz, tz)


def test_transforms():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    close(jtf.quat_to_rotmat(jnp.asarray(q)), ttf.quat_to_rotmat(
        torch.tensor(q)))
    jw = jtf.build_w2c(jnp.asarray(q), jnp.asarray(t))
    tw = ttf.build_w2c(torch.tensor(q), torch.tensor(t))
    close(jw, tw)
    close(jtf.invert_se3(jw), ttf.invert_se3(tw))
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    close(jtf.transform_points(jw[0], jnp.asarray(pts)),
          ttf.transform_points(tw[0], torch.tensor(pts)))
    close(jtf.essential_from_poses(jw[0], jw[1]),
          ttf.essential_from_poses(tw[0], tw[1]))
    K = jcam.Camera(10, 12, 9.0, 9.5, 6.0, 5.0).intrinsic_matrix()
    close(jtf.fundamental_from_essential(jtf.essential_from_poses(
        jw[2], jw[3]), jnp.asarray(K), jnp.asarray(K)),
        ttf.fundamental_from_essential(ttf.essential_from_poses(
            tw[2], tw[3]), torch.tensor(K), torch.tensor(K)), rtol=1e-4)


def test_quat_rotmat_gradient():
    """Gradients through the normalization + polynomial agree."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    w = rng.normal(size=(5, 3, 3)).astype(np.float32)
    gj = jax.grad(lambda x: jnp.sum(jtf.quat_to_rotmat(x) * w))(
        jnp.asarray(q))
    qt = torch.tensor(q, requires_grad=True)
    (ttf.quat_to_rotmat(qt) * torch.tensor(w)).sum().backward()
    close(gj, qt.grad, atol=1e-5)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(3 + degree)
    k = (degree + 1) ** 2
    sh = rng.normal(size=(64, 16, 3)).astype(np.float32)[:, :max(k, 1)]
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    close(jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(dirs)),
          tsh.eval_sh(degree, torch.tensor(sh), torch.tensor(dirs)))
    close(jsh.sh_to_rgb_clamped(degree, jnp.asarray(sh), jnp.asarray(dirs)),
          tsh.sh_to_rgb_clamped(degree, torch.tensor(sh),
                                torch.tensor(dirs)))


def test_rgb2sh_roundtrip():
    rgb = np.linspace(0.0, 1.0, 30, dtype=np.float32).reshape(10, 3)
    close(jsh.rgb2sh(jnp.asarray(rgb)), tsh.rgb2sh(torch.tensor(rgb)))
    close(jsh.sh2rgb(jsh.rgb2sh(jnp.asarray(rgb))),
          tsh.sh2rgb(tsh.rgb2sh(torch.tensor(rgb))))
