"""The port's Gaussian field, pose table and densification against
freesurgs_tpu's, with state carried across by ``freesurgs_tpu_torch.convert``.

Tolerances: initialization is the same f32 arithmetic (3-NN distances via
|x|^2 + |y|^2 - 2 x.y in both: rtol 1e-5); densify's split children use
JAX's own normal draws, so field tensors, masks and Adam moments after the
surgery must agree to 1e-6 and slot masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.models import gaussians as jg
from freesurgs_tpu.models import pose as jpose
from freesurgs_tpu.ops.knn import initial_log_scales as jknn
from freesurgs_tpu.train import densify as jd
from freesurgs_tpu.train.optim import AdamState as JAdam
from freesurgs_tpu_torch.convert import adam_from_numpy, field_from_numpy, \
    poses_from_numpy
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.models import gaussians as tg
from freesurgs_tpu_torch.models import pose as tpose
from freesurgs_tpu_torch.ops.knn import initial_log_scales as tknn
from freesurgs_tpu_torch.train import densify as td

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

FIELDS = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
          "sh_rest", "active", "max_radii2d", "grad_accum", "grad_denom",
          "scene_radius")


def field_np(f):
    return {k: np.asarray(getattr(f, k)) for k in FIELDS}


def assert_field(jf, tf, atol=1e-6, rtol=1e-5):
    for k in FIELDS:
        a, b = np.asarray(getattr(jf, k)), getattr(tf, k).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=k)


def test_initial_log_scales():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jknn(jnp.asarray(pts))),
                               tknn(torch.tensor(pts)).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_from_rgbd():
    rng = np.random.default_rng(1)
    H, W = 24, 30
    kw = dict(height=H, width=W, fx=30.0, fy=30.0, cx=15.0, cy=12.0)
    color = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    depth = rng.uniform(0.5, 1.5, (H, W)).astype(np.float32)
    mask = rng.uniform(size=H * W) < 0.3
    jf = jg.from_rgbd(jnp.asarray(color), jnp.asarray(depth), JCam(**kw),
                      jnp.eye(4), mask, 3)
    tf = tg.from_rgbd(torch.tensor(color), torch.tensor(depth), TCam(**kw),
                      torch.eye(4), mask, 3)
    assert jf.capacity == tf.capacity
    assert_field(jf, tf)


def test_grow_capacity():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    jf = jg.from_pointcloud(jnp.asarray(pts), jnp.asarray(cols), 1.0, 3,
                            capacity=128)
    tf = field_from_numpy(field_np(jf), device="cpu")
    assert_field(jg.grow_capacity(jf, 256), tg.grow_capacity(tf, 256))


def test_pose_table_and_rigidity():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(4, 4)).astype(np.float32) * 0.05
    q[:, 0] = 1.0
    t = rng.normal(size=(4, 3)).astype(np.float32) * 0.05
    jp = jpose.PoseTable(quats=jnp.asarray(q), trans=jnp.asarray(t))
    tp = poses_from_numpy(q, t, device="cpu")
    np.testing.assert_allclose(np.asarray(jp.all_w2c()),
                               tp.all_w2c().numpy(), atol=1e-6)
    jc, tc = jpose.const_velocity_init(jp, 3), tpose.const_velocity_init(tp, 3)
    np.testing.assert_allclose(np.asarray(jc.quats), tc.quats.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jc.trans), tc.trans.numpy(),
                               atol=1e-6)
    cp = tpose.copy_previous_init(tp, 2)
    np.testing.assert_array_equal(cp.quats[2].numpy(), q[1])

    kw = dict(height=30, width=40, fx=40.0, fy=40.0, cx=20.0, cy=15.0)
    K = JCam(**kw).intrinsic_matrix()
    flow = rng.normal(0, 2.0, (2, 30, 40)).astype(np.float32)
    jm, jmap = jpose.epipolar_rigidity(jp, 1, 2, jnp.asarray(flow),
                                       JCam(**kw), jnp.asarray(K))
    tm, tmap = tpose.epipolar_rigidity(tp, 1, 2, torch.tensor(flow),
                                       TCam(**kw), torch.tensor(K))
    np.testing.assert_allclose(np.asarray(jmap), tmap.numpy(), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(jpose.adaptive_threshold_mask(jmap)),
        tpose.adaptive_threshold_mask(torch.tensor(np.asarray(jmap))).numpy())


def densify_setup(c=96, n=80, seed=4):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    f = jg.from_pointcloud(jnp.asarray(pts), jnp.asarray(cols), 3.0, 1,
                           capacity=c)
    act = np.asarray(f.active)
    f = f.replace(
        quats=jnp.asarray(rng.normal(size=(c, 4)).astype(np.float32)),
        log_scales=jnp.asarray(np.log(rng.uniform(0.003, 0.04, (c, 3)))
                               .astype(np.float32)),
        logit_opacity=jnp.asarray(rng.uniform(-4, 2, c).astype(np.float32)),
        grad_accum=jnp.asarray((rng.uniform(0, 6e-4, c) * act)
                               .astype(np.float32)),
        grad_denom=jnp.asarray((rng.integers(0, 3, c) * act)
                               .astype(np.float32)))
    mu = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in f.param_dict().items()}
    nu = {k: rng.uniform(size=v.shape).astype(np.float32)
          for k, v in f.param_dict().items()}
    jopt = JAdam(mu={k: jnp.asarray(v) for k, v in mu.items()},
                 nu={k: jnp.asarray(v) for k, v in nu.items()},
                 count=jnp.int32(7))
    return f, jopt, adam_from_numpy(mu, nu, 7, device="cpu")


def assert_opt(jo, to):
    assert int(jo.count) == to.count
    for k in jo.mu:
        np.testing.assert_allclose(np.asarray(jo.mu[k]), to.mu[k].numpy(),
                                   atol=1e-7)
        np.testing.assert_allclose(np.asarray(jo.nu[k]), to.nu[k].numpy(),
                                   atol=1e-7)


@pytest.mark.parametrize("capacity,size_gate", [(200, False), (96, True)])
def test_densify_and_prune(capacity, size_gate):
    """Clone, split and prune at fixed capacity; capacity 96 leaves too few
    free slots, so children are dropped. The split noise is JAX's draw."""
    jf, jopt, topt = densify_setup(c=capacity)
    tf = field_from_numpy(field_np(jf), device="cpu", max_sh_degree=1)
    key = jax.random.PRNGKey(11)
    cfg = jd.DensifyConfig()
    jf2, jopt2, js = jd.densify_and_prune(jf, jopt, key, cfg, size_gate)
    k1, _ = jax.random.split(key)
    noise = torch.tensor(np.asarray(jax.random.normal(k1, (2, capacity, 3))))
    tf2, topt2, ts = td.densify_and_prune(tf, topt, noise, td.DensifyConfig(),
                                          size_gate)
    assert int(js.cloned) > 0 and int(js.split) > 0 and int(js.pruned) > 0
    for name in jd.DensifyStats._fields:
        assert int(getattr(js, name)) == int(getattr(ts, name)), name
    if capacity == 96:
        assert int(ts.dropped) > 0
    assert_field(jf2, tf2)
    assert_opt(jopt2, topt2)

    jf3, jopt3 = jd.reset_opacity(jf2, jopt2)
    tf3, topt3 = td.reset_opacity(tf2, topt2)
    assert_field(jf3, tf3)
    assert_opt(jopt3, topt3)


def test_add_render_stats():
    jf, _, _ = densify_setup()
    tf = field_from_numpy(field_np(jf), device="cpu", max_sh_degree=1)
    rng = np.random.default_rng(5)
    c = jf.capacity
    g = rng.normal(size=(c, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 30, c).astype(np.int32)
    vis = radii > 3
    scale = np.asarray([24.0, 20.0], np.float32)
    assert_field(jd.add_render_stats(jf, jnp.asarray(g), jnp.asarray(radii),
                                     jnp.asarray(vis), jnp.asarray(scale)),
                 td.add_render_stats(tf, torch.tensor(g), torch.tensor(radii),
                                     torch.tensor(vis), torch.tensor(scale)))
