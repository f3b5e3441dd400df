"""The port's small public helpers against the JAX package's: the camera's
``fov2focal`` and ``opengl_projection_matrix``, ``euler_degrees_to_rotmat``,
the native library probe ``io.native.available`` and ``ops.render.grid_dims``
(1e-6, or equal where the result is an integer or a flag)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core import camera as jcamera
from freesurgs_tpu.core import transforms as jtransforms
from freesurgs_tpu.io import native as jnative
from freesurgs_tpu.ops import render as jrender
from freesurgs_tpu_torch.core import camera as tcamera
from freesurgs_tpu_torch.core import transforms as ttransforms
from freesurgs_tpu_torch.io import native as tnative
from freesurgs_tpu_torch.ops import render as trender

torch.set_num_threads(1)

CAMS = [(48, 64, 60.0, 58.0, 31.5, 24.25), (1024, 1280, 1100.0, 1090.0,
                                             640.0, 512.0),
        (100, 37, 45.0, 45.0, 20.0, 51.0)]


def cams(i):
    h, w, fx, fy, cx, cy = CAMS[i]
    return (jcamera.Camera(height=h, width=w, fx=fx, fy=fy, cx=cx, cy=cy),
            tcamera.Camera(height=h, width=w, fx=fx, fy=fy, cx=cx, cy=cy))


def fov2focal():
    rng = np.random.default_rng(0)
    for fov, px in zip(rng.uniform(0.1, 3.0, 16), rng.integers(8, 4096, 16)):
        want = jcamera.fov2focal(float(fov), int(px))
        got = tcamera.fov2focal(float(fov), int(px))
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(
            tcamera.focal2fov(got, int(px)), float(fov), rtol=1e-6)


def opengl_projection_matrix():
    for i in range(len(CAMS)):
        jc, tc = cams(i)
        got = tcamera.opengl_projection_matrix(tc)
        want = jcamera.opengl_projection_matrix(jc)
        assert got.dtype == want.dtype and got.shape == (4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def euler_degrees_to_rotmat():
    rng = np.random.default_rng(1)
    for e in rng.uniform(-360.0, 360.0, (16, 3)).astype(np.float32):
        want = np.asarray(jtransforms.euler_degrees_to_rotmat(jnp.asarray(e)))
        got = ttransforms.euler_degrees_to_rotmat(torch.tensor(e)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-6)


def available():
    assert tnative.available() is jnative.available()


def grid_dims():
    for i in range(len(CAMS)):
        jc, tc = cams(i)
        assert trender.grid_dims(tc) == jrender.grid_dims(jc)


@pytest.mark.parametrize("case", [fov2focal, opengl_projection_matrix,
                                  euler_degrees_to_rotmat, available,
                                  grid_dims], ids=lambda f: f.__name__)
def test_helper_matches_jax(case):
    case()
