"""The slice as a whole against the JAX package: ``tracking_loop`` on a frozen
field, ``mapping_chunk`` (one-view and two-view, with the opacity reset
firing) and ``Trainer.progressive_run`` on a 2-frame synthetic scene. The
JAX side renders with ``impl="oracle"``, the port through its binned
compositing (the plain kernel versions on the CPU).

Tolerances. Every step's gradients agree to f32 reassociation (~1e-6
relative, tests/test_torch_render.py), but Adam divides each gradient by
its own running RMS, so a gradient component that is itself rounding noise
(a sum that nearly cancels) can move its parameter by a sizeable part of
its learning rate. Over the 4 mapping steps of one chunk that stays below
1e-5 (measured: 3.6e-6 at worst), held at 2e-5. Over the Trainer's 12
mapping steps, after 5 tracking steps have moved the pose, the worst
element reaches 1.5e-4 (a quaternion, LR 1e-3): held at 1e-3, one step of
that LR, while 99% of the elements must agree to 1e-5. Poses and losses,
which aggregate many pixels, to 1e-5 absolute and 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.data.synthetic import make_scene
from freesurgs_tpu.models.gaussians import GaussianField as JField
from freesurgs_tpu.train import steps as js
from freesurgs_tpu.train.densify import DensifyConfig
from freesurgs_tpu.train.loop import Trainer as JTrainer
from freesurgs_tpu.train.optim import adam_init as jadam_init
from freesurgs_tpu_torch.convert import field_from_numpy
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.train import steps as ts
from freesurgs_tpu_torch.train.loop import Trainer as TTrainer
from freesurgs_tpu_torch.train.optim import adam_init as tadam_init

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

PARAMS = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
          "sh_rest")


def tcam(cam):
    return TCam(height=cam.height, width=cam.width, fx=cam.fx, fy=cam.fy,
                cx=cam.cx, cy=cam.cy)


def close_params(a, b, name, atol=2e-5, bulk=1e-5):
    a = np.asarray(a)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
    err = np.abs(a - b).ravel()
    if err.size:
        assert np.quantile(err, 0.99) <= bulk, (name, np.quantile(err, 0.99))


@pytest.fixture(scope="module")
def scene():
    sc = make_scene(num_frames=2, n_gaussians=250, height=64, width=80,
                    seed=3)
    rng = np.random.default_rng(0)
    n, cap = 250, 320
    sh_rest = np.zeros((cap, 3, 3), np.float32)
    sh_rest[:n] = rng.normal(size=(n, 3, 3)) * 0.05

    def pad(x, fill=0.0):
        x = np.asarray(x)
        out = np.full((cap,) + x.shape[1:], fill, x.dtype)
        out[:n] = x
        return out

    quats = pad(sc.quats)
    quats[n:, 0] = 1.0
    arrays = dict(means=pad(sc.means), quats=quats,
                  log_scales=pad(sc.log_scales),
                  logit_opacity=pad(sc.logit_opacity),
                  sh_dc=pad(sc.sh), sh_rest=sh_rest,
                  active=np.arange(cap) < n,
                  max_radii2d=np.zeros(cap, np.float32),
                  grad_accum=np.zeros(cap, np.float32),
                  grad_denom=np.zeros(cap, np.float32),
                  scene_radius=np.float32(1.0))
    jf = JField(**{k: jnp.asarray(v) for k, v in arrays.items()},
                max_sh_degree=1)
    return sc, jf, field_from_numpy(arrays, device="cpu", max_sh_degree=1)


def test_tracking_loop(scene):
    """Pose-only optimization on a frozen field: the same pose as JAX."""
    sc, jf, tf = scene
    kw = dict(tracking_iters=6, tracking_gn_iters=0)
    q0 = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    t0 = np.zeros(3, np.float32)
    inputs = (np.asarray(sc.colors[1]), np.asarray(sc.depths[0]),
              np.asarray(sc.gt_w2c[0]), np.asarray(sc.flows_fw[0]),
              np.ones((64, 80), np.float32))
    jq, jt, jm = js.tracking_loop(
        jf, jnp.asarray(q0), jnp.asarray(t0), *map(jnp.asarray, inputs),
        sc.cam, js.TrainConfig(impl="oracle", **kw), sh_degree=1)
    tq, tt, tm = ts.tracking_loop(
        tf, torch.tensor(q0), torch.tensor(t0),
        *(torch.tensor(x) for x in inputs), tcam(sc.cam),
        ts.TrainConfig(**kw), sh_degree=1)
    assert float(jm["flow_loss"]) > 0          # the flow term is live
    np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jq), tq.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5)
    assert float(tm["nonfinite_grads"]) == 0
    assert float(tm["overflow"]) == 0          # reported on this path too


def test_tracking_loop_zero_iters_metrics(scene):
    """With tracking_iters=0 the metrics carry JAX's keys, with JAX's
    zeros, and the pose stays at its init."""
    sc, jf, tf = scene
    kw = dict(tracking_iters=0, tracking_gn_iters=0)
    q0 = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    t0 = np.asarray([0.01, -0.02, 0.0], np.float32)
    inputs = (np.asarray(sc.colors[1]), np.asarray(sc.depths[0]),
              np.asarray(sc.gt_w2c[0]), np.asarray(sc.flows_fw[0]),
              np.ones((64, 80), np.float32))
    jq, jt, jm = js.tracking_loop(
        jf, jnp.asarray(q0), jnp.asarray(t0), *map(jnp.asarray, inputs),
        sc.cam, js.TrainConfig(impl="oracle", **kw), sh_degree=1)
    tq, tt, tm = ts.tracking_loop(
        tf, torch.tensor(q0), torch.tensor(t0),
        *(torch.tensor(x) for x in inputs), tcam(sc.cam),
        ts.TrainConfig(**kw), sh_degree=1)
    assert set(jm) <= set(tm), (sorted(jm), sorted(tm))
    for k in jm:
        assert float(tm[k]) == float(jm[k]) == 0.0, k
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


@pytest.mark.parametrize("impl", [None, "raster", "oracle"])
def test_impl_renders_only_through_the_kernels(impl):
    """TrainConfig.impl is kept for field parity; anything but the kernels'
    path raises instead of rendering another way."""
    cfg = ts.TrainConfig(tracking_gn_iters=0, impl=impl)
    if impl == "oracle":
        with pytest.raises(NotImplementedError, match="oracle"):
            ts.check_supported(cfg)
    else:
        ts.check_supported(cfg)


@pytest.mark.parametrize("two_views", [False, True])
def test_mapping_chunk(scene, two_views):
    """Mapping iterations with the opacity reset firing at iteration 3."""
    sc, jf, tf = scene
    n_it = 4
    cfg_kw = dict(w_local_pearson=0.0, opacity_reset_interval=3,
                  densify_interval=1000)
    colors, monodeps = np.asarray(sc.colors), np.asarray(sc.monodeps)
    w2c = np.asarray(sc.gt_w2c)
    jstate = js.MappingState(
        field=jf, opt=jadam_init(jf.param_dict()), iteration=jnp.int32(0),
        key=jax.random.PRNGKey(0),
        pred_depths=jnp.zeros((2, 64, 80), jnp.bfloat16),
        pred_colors=jnp.zeros((2, 3, 64, 80), jnp.bfloat16))
    jst, jaux = js.mapping_chunk(
        jstate, jnp.asarray(colors), jnp.asarray(monodeps), jnp.asarray(w2c),
        jnp.full((n_it,), 1, jnp.int32), jnp.zeros((2,), jnp.int32),
        jnp.int32(1), sc.cam, js.TrainConfig(impl="oracle", **cfg_kw),
        two_views, 1)
    tstate = ts.MappingState(
        field=tf, opt=tadam_init(tf.param_dict()), iteration=0,
        generator=torch.Generator().manual_seed(0),
        pred_depths=torch.zeros(2, 64, 80, dtype=torch.bfloat16),
        pred_colors=torch.zeros(2, 3, 64, 80, dtype=torch.bfloat16))
    tst, taux = ts.mapping_chunk(
        tstate, torch.tensor(colors), torch.tensor(monodeps),
        torch.tensor(w2c), [1] * n_it, [0], tcam(sc.cam),
        ts.TrainConfig(**cfg_kw), two_views, 1)
    assert tst.iteration == int(jst.iteration) == n_it
    assert taux["opacity_resets"] == 1
    assert float(taux["overflow_max"]) == 0    # both views' renders
    np.testing.assert_allclose(float(jaux["loss"]), float(taux["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jaux["loss_terms"]),
                               taux["loss_terms"].numpy(), rtol=1e-4,
                               atol=1e-7)
    for k in PARAMS:
        close_params(getattr(jst.field, k), getattr(tst.field, k), k)
        close_params(jst.opt.mu[k], tst.opt.mu[k], "mu " + k, atol=1e-6,
                     bulk=3e-7)
        close_params(jst.opt.nu[k], tst.opt.nu[k], "nu " + k, atol=3e-9,
                     bulk=1e-9)
    for k in ("grad_accum", "grad_denom", "max_radii2d"):
        np.testing.assert_allclose(np.asarray(getattr(jst.field, k)),
                                   getattr(tst.field, k).numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        np.asarray(jst.pred_depths, np.float32),
        tst.pred_depths.float().numpy(), atol=2e-2)


@pytest.mark.parametrize("poisoned", [False, True])
def test_first_nonfinite_iter_sentinel(scene, poisoned):
    """aux["first_nonfinite_iter"] as JAX reports it: the chunk length when
    no iteration saw a non-finite gradient, else the first such iteration
    (a NaN colour on one visible Gaussian poisons iteration 0 on)."""
    sc, jf, tf = scene
    n_it = 3
    cfg_kw = dict(w_local_pearson=0.0, densify_interval=1000)
    sh_dc = np.array(jf.sh_dc)
    if poisoned:
        sh_dc[0] = np.nan
    jf = jf.replace(sh_dc=jnp.asarray(sh_dc))
    tf = tf.replace(sh_dc=torch.tensor(sh_dc))
    colors, monodeps = np.asarray(sc.colors), np.asarray(sc.monodeps)
    w2c = np.asarray(sc.gt_w2c)
    jstate = js.MappingState(
        field=jf, opt=jadam_init(jf.param_dict()), iteration=jnp.int32(0),
        key=jax.random.PRNGKey(0),
        pred_depths=jnp.zeros((2, 64, 80), jnp.bfloat16),
        pred_colors=jnp.zeros((2, 3, 64, 80), jnp.bfloat16))
    _, jaux = js.mapping_chunk(
        jstate, jnp.asarray(colors), jnp.asarray(monodeps), jnp.asarray(w2c),
        jnp.full((n_it,), 1, jnp.int32), jnp.zeros((2,), jnp.int32),
        jnp.int32(1), sc.cam, js.TrainConfig(impl="oracle", **cfg_kw),
        False, 1)
    tstate = ts.MappingState(
        field=tf, opt=tadam_init(tf.param_dict()), iteration=0,
        generator=torch.Generator().manual_seed(0),
        pred_depths=torch.zeros(2, 64, 80, dtype=torch.bfloat16),
        pred_colors=torch.zeros(2, 3, 64, 80, dtype=torch.bfloat16))
    _, taux = ts.mapping_chunk(
        tstate, torch.tensor(colors), torch.tensor(monodeps),
        torch.tensor(w2c), [1] * n_it, [0], tcam(sc.cam),
        ts.TrainConfig(**cfg_kw), False, 1)
    want = 0 if poisoned else n_it
    assert int(jaux["first_nonfinite_iter"]) == want
    assert int(taux["first_nonfinite_iter"]) == want
    assert (float(taux["nonfinite_grads"]) > 0) == poisoned


class JSeq:
    def __init__(self, sc):
        self.cam = sc.cam
        self.colors = np.asarray(sc.colors)
        self.monodeps = np.asarray(sc.monodeps)
        self.flows_fw = np.asarray(sc.flows_fw)
        n = self.colors.shape[0]
        self.i_train = np.arange(n)
        self.i_test = np.asarray([n - 1])
        self.gt_poses = {"k0": np.asarray(sc.gt_w2c)}
        self.boundaries = [0, n]


def test_trainer_progressive_run():
    sc = make_scene(num_frames=2, n_gaussians=300, height=32, width=48,
                    seed=5)
    kw = dict(tracking_iters=5, mapping_iters=4, first_frame_mapping_iters=8,
              tracking_gn_iters=0, w_local_pearson=0.0,
              densify_interval=10_000, opacity_reset_interval=10_000)
    jseq = JSeq(sc)
    jtr = JTrainer(jseq, js.TrainConfig(impl="oracle", max_instances=16384,
                                        densify=DensifyConfig(), **kw),
                   sh_degree_max=0, capacity=4096, log_fn=lambda *a: None)
    jtr.progressive_run()
    tseq = JSeq(sc)
    tseq.cam = tcam(sc.cam)
    ttr = TTrainer(tseq, ts.TrainConfig(**kw), sh_degree_max=0,
                   capacity=4096, log_fn=lambda *a: None, device="cpu")
    ttr.progressive_run()

    assert ttr.keyframes == jtr.keyframes == [0, 1]
    assert ttr.state.iteration == int(jtr.state.iteration) == 12
    assert all(float(h["overflow"]) == 0 for h in ttr.history)
    for jh, th in zip(jtr.history, ttr.history):
        for k in ("loss", "rgb_loss", "flow_loss", "rgb", "pear"):
            if k in jh:
                np.testing.assert_allclose(float(jh[k]), float(th[k]),
                                           rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(np.asarray(jtr.poses.quats),
                               ttr.poses.quats.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jtr.poses.trans),
                               ttr.poses.trans.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jtr.field.active),
                                  ttr.field.active.numpy())
    for k in PARAMS:
        close_params(getattr(jtr.field, k), getattr(ttr.field, k), k,
                     atol=1e-3)


def test_maybe_grow_pads_field_and_moments():
    """Past 90% occupancy the slot pool doubles (4096 quanta, capped at
    max_capacity), padding the field and both Adam moments: the rule of
    freesurgs_tpu/train/loop.py _maybe_grow."""
    from freesurgs_tpu_torch.data.synthetic import SceneSequence, \
        make_scene as tmake_scene
    sc = tmake_scene(num_frames=2, n_gaussians=100, height=32, width=48,
                     seed=1, device="cpu")
    tr = TTrainer(SceneSequence(sc), ts.TrainConfig(tracking_gn_iters=0),
                  sh_degree_max=0, init_mask_frac=0.5, capacity=768,
                  max_capacity=5000, log_fn=lambda *a: None, device="cpu")
    assert int(tr.field.num_active) == 768      # full pool
    before = tr.field.means.clone()
    tr._maybe_grow()
    assert tr.field.capacity == 4096            # ceil(1536 / 4096) quanta
    assert torch.equal(tr.field.means[:768], before)
    assert not tr.field.active[768:].any()
    assert torch.all(tr.field.quats[768:, 0] == 1.0)
    for k in PARAMS:
        assert tr.state.opt.mu[k].shape[0] == 4096
        assert tr.state.opt.nu[k].shape[0] == 4096
    tr.state.field.active[:] = True
    tr._maybe_grow()
    assert tr.field.capacity == 5000            # the max_capacity ceiling
