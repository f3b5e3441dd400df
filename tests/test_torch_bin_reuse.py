"""The binning-layout carry (``ops/raster_cuda.py``, "the layout carry")
against the JAX ``BinState`` (``render(impl="pallas_interpret", bins=,
rebin=)``), and the training loops that carry it: ``tracking_loop`` with
``rebin_tracking_every``, ``mapping_chunk`` with ``rebin_every`` (one
view with a densify event; two views with the sorted keyframe draws) and
``global_run``'s sorted chunk order.

The render cases are the counterparts of tests/test_bin_reuse.py on its
48x64 camera and 150-Gaussian scene. The two binners lay out the same
slots, so each stale render is compared slot for slot.

Tolerances: rendered channels 2e-5 absolute (the JAX package's
oracle-vs-Pallas gate; both sum the same terms in another order), 1e-6
between a stale and a fresh port render where the coverage only shrank
(the fresh layout drops empty instances, shifting chunk boundaries),
bitwise where nothing moved; gradients 5e-5 after normalizing by their
largest magnitude; poses 1e-5. Mapping parameters after a chunk: the
JAX package's own Pallas and oracle paths differ by up to 6.5e-5 (99% of
entries 2.2e-5) on the chunks below (4 one-view steps; 3 two-view steps:
4.6e-5), the port's plain version following the oracle, so
``close_params`` holds them to 1e-4 (99% to 5e-5). That spread grows
with the chunk (5.8e-4 after 4 two-view steps), hence the short chunks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.ops.raster_pallas import zero_bin_state
from freesurgs_tpu.ops.render import raster_config as jraster_config
from freesurgs_tpu.ops.render import render as jrender
from freesurgs_tpu.train import densify as jd
from freesurgs_tpu.train import steps as js
from freesurgs_tpu.train.optim import adam_init as jadam_init
from freesurgs_tpu_torch.ops import raster_cuda as rc
from freesurgs_tpu_torch.ops.render import render as trender
from freesurgs_tpu_torch.train import densify as td
from freesurgs_tpu_torch.train import loop as tloop
from freesurgs_tpu_torch.train import steps as ts
from freesurgs_tpu_torch.train.optim import adam_init as tadam_init

from test_pallas_raster import make_scene as raster_scene
from test_torch_train import PARAMS, close_params, scene, tcam  # noqa: F401

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

CAM = JCam(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
TCAM = tcam(CAM)
N = 150
MAXI = 4096
JKW = dict(impl="pallas_interpret", max_instances=MAXI)


def _jbins0(n, maxi=MAXI):
    return zero_bin_state(n, jraster_config(CAM, maxi, n, "pallas_interpret"))


def _t(args):
    return [torch.tensor(np.asarray(a)) for a in args]


def _jr(args, **kw):
    return jrender(*args, jnp.eye(4), CAM, **{**JKW, **kw})


def _tr(args, **kw):
    return trender(*args, torch.eye(4), TCAM, **{"max_instances": MAXI, **kw})


def _close(j, t, key, atol=2e-5):
    np.testing.assert_allclose(np.asarray(j[key]), t[key].detach().numpy(),
                               atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def base():
    """The scene and its fresh-with-carry render in both packages."""
    args = raster_scene(np.random.default_rng(0), N)
    j1 = _jr(args, bins=_jbins0(N), rebin=jnp.bool_(True))
    t1 = _tr(_t(args), rebin=True)
    return args, j1, t1


def test_reuse_same_params_identical(base):
    """Reuse with nothing moved is bitwise the fresh render, and the port's
    layout is JAX's slot for slot."""
    args, j1, t1 = base
    targs = _t(args)
    fresh = _tr(targs)
    t2 = _tr(targs, bins=t1["bins"], rebin=False)
    j2 = _jr(args, bins=j1["bins"], rebin=jnp.bool_(False))
    for k in ("render", "render_dep", "final_T"):
        assert torch.equal(fresh[k], t1[k]) and torch.equal(t1[k], t2[k]), k
        _close(j2, t2, k, atol=2e-5 if k != "render_dep" else 1e-4)
    assert "bins" not in fresh and t2["bins"] is t1["bins"]
    jb, tb = j1["bins"], t1["bins"]
    m = tb.gather_idx.shape[0]
    np.testing.assert_array_equal(np.asarray(jb.tile_start),
                                  tb.tile_start.numpy())
    np.testing.assert_array_equal(np.asarray(jb.tile_count),
                                  tb.tile_count.numpy())
    np.testing.assert_array_equal(np.asarray(jb.gather_idx)[:m],
                                  tb.gather_idx.numpy())
    assert np.all(np.asarray(jb.gather_idx)[m:] == N)
    assert int(tb.num_instances) == int(jb.num_instances) > 0
    assert int(t2["overflow"]) == int(j2["overflow"]) == 0


def test_reuse_shrunk_coverage_exact(base):
    """Opacity down everywhere and 10 Gaussians faded below 1/255 (pruned,
    their packed rect is 0): the stale layout composites the same
    (pixel, Gaussian) set as a fresh one."""
    args, j1, t1 = base
    args = list(args)
    lo = np.asarray(args[3]) - 0.5
    lo[:10] = -10.0
    args[3] = jnp.asarray(lo)
    targs = _t(args)
    stale = _tr(targs, bins=t1["bins"], rebin=False)
    fresh = _tr(targs)
    jstale = _jr(args, bins=j1["bins"], rebin=jnp.bool_(False))
    for k in ("render", "final_T"):
        np.testing.assert_allclose(stale[k].numpy(), fresh[k].numpy(),
                                   atol=1e-6, err_msg=k)
        _close(jstale, stale, k)


def test_reuse_small_motion_matches_jax(base):
    """Sub-pixel motion between rebins: the stale render may lose slivers
    at bin borders; the port loses the same ones as JAX."""
    args, j1, t1 = base
    args = list(args)
    args[0] = args[0] + jnp.asarray([2e-4, -1e-4, 0.0])
    targs = _t(args)
    stale = _tr(targs, bins=t1["bins"], rebin=False)
    fresh = _tr(targs)
    jstale = _jr(args, bins=j1["bins"], rebin=jnp.bool_(False))
    for k in ("render", "final_T"):
        _close(jstale, stale, k)
    assert float((stale["render"] - fresh["render"]).abs().max()) < 1e-2


def test_stale_gradients_match_jax(base):
    """Gradients under a stale layout are the VJP of the stale forward:
    the same as JAX's through its same stale layout."""
    args, j1, t1 = base
    args = list(args)
    args[0] = args[0] + jnp.asarray([3e-4, -2e-4, 1e-4])

    def jloss(lo, means):
        out = jrender(means, args[1], args[2], lo, args[4], jnp.eye(4), CAM,
                      bins=j1["bins"], rebin=jnp.bool_(False), **JKW)
        return jnp.mean((out["render"] - 0.3) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(args[3], args[0])
    targs = _t(args)
    lo = targs[3].requires_grad_(True)
    means = targs[0].requires_grad_(True)
    out = trender(means, targs[1], targs[2], lo, targs[4], torch.eye(4),
                  TCAM, max_instances=MAXI, bins=t1["bins"], rebin=False)
    tg = torch.autograd.grad(torch.mean((out["render"] - 0.3) ** 2),
                             (lo, means))
    for j, t, name in zip(jg, tg, ("logit_opacity", "means")):
        j = np.asarray(j)
        scale = np.abs(j).max()
        assert scale > 0
        assert np.abs(j - t.numpy()).max() / scale <= 5e-5, name


def test_rebin_flag_recovers_fresh(base):
    """After a large move, rebin=True with a carry is bitwise the fresh
    render, and the same as JAX's."""
    args, j1, t1 = base
    args = list(args)
    args[0] = args[0] + jnp.asarray([0.05, 0.02, -0.01])
    targs = _t(args)
    t2 = _tr(targs, bins=t1["bins"], rebin=True)
    fresh = _tr(targs)
    j2 = _jr(args, bins=j1["bins"], rebin=jnp.bool_(True))
    assert torch.equal(t2["render"], fresh["render"])
    assert t2["bins"] is not t1["bins"]
    _close(j2, t2, "render")


def test_reuse_overflow_is_jax_quantity(base):
    """On a carried layout overflow is JAX's max(0, current coverage -
    capacity), computed on the device; the fresh render under the same
    cap reports the instances it dropped."""
    args, _, t1 = base
    cap = 256                    # a multiple of 128: the same M for both
    j1 = _jr(args, bins=_jbins0(N, cap), rebin=jnp.bool_(True),
             max_instances=cap)
    j2 = _jr(args, bins=j1["bins"], rebin=jnp.bool_(False),
             max_instances=cap)
    targs = _t(args)
    t_small = _tr(targs, rebin=True, max_instances=cap)
    t2 = _tr(targs, bins=t_small["bins"], rebin=False, max_instances=cap)
    total = int(t1["num_instances"])
    assert int(j2["overflow"]) == int(t2["overflow"]) == total - cap > 0
    assert int(t_small["overflow"]) >= total - cap


def test_render_carry_arguments():
    args = _t(raster_scene(np.random.default_rng(1), 20))
    with pytest.raises(ValueError, match="rebin flag"):
        _tr(args, bins=_tr(args, rebin=True)["bins"])
    with pytest.raises(ValueError, match="reuse"):
        _tr(args, rebin=False)


# ------------------------------------------------------------ the loops

def _jstate(jf, T=2, H=64, W=80):
    return js.MappingState(
        field=jf, opt=jadam_init(jf.param_dict()), iteration=jnp.int32(0),
        key=jax.random.PRNGKey(0),
        pred_depths=jnp.zeros((T, H, W), jnp.bfloat16),
        pred_colors=jnp.zeros((T, 3, H, W), jnp.bfloat16))


def _tstate(tf, T=2, H=64, W=80):
    return ts.MappingState(
        field=tf, opt=tadam_init(tf.param_dict()), iteration=0,
        generator=torch.Generator().manual_seed(0),
        pred_depths=torch.zeros(T, H, W, dtype=torch.bfloat16),
        pred_colors=torch.zeros(T, 3, H, W, dtype=torch.bfloat16))


def expected_bins(ts_seq, it0, cfg):
    """Renders of one carried view that bin: force | new frame |
    k % rebin_every == 0, force after the previous iteration's densify or
    opacity reset."""
    n, prev, force = 0, None, True
    for k, t in enumerate(ts_seq):
        n += force or t != prev or k % cfg.rebin_every == 0
        prev, it = t, it0 + k + 1
        force = ((it % cfg.densify_interval == 0 and it < cfg.densify_until)
                 or it % cfg.opacity_reset_interval == 0)
    return n


def test_tracking_loop_rebin_every_2(scene):
    sc, jf, tf = scene
    kw = dict(tracking_iters=5, tracking_gn_iters=0, rebin_tracking_every=2)
    q0 = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    t0 = np.zeros(3, np.float32)
    inputs = (np.asarray(sc.colors[1]), np.asarray(sc.depths[0]),
              np.asarray(sc.gt_w2c[0]), np.asarray(sc.flows_fw[0]),
              np.ones((64, 80), np.float32))
    jq, jt, jm = js.tracking_loop(
        jf, jnp.asarray(q0), jnp.asarray(t0), *map(jnp.asarray, inputs),
        sc.cam, js.TrainConfig(impl="pallas_interpret", max_instances=MAXI,
                               **kw), sh_degree=1)
    rc.reset_bins()
    tq, tt, tm = ts.tracking_loop(
        tf, torch.tensor(q0), torch.tensor(t0),
        *(torch.tensor(x) for x in inputs), tcam(sc.cam),
        ts.TrainConfig(**kw), sh_degree=1)
    assert rc.BINS["build_tile_bins"] == 3          # i = 0, 2, 4
    np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jq), tq.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), atol=1e-5)
    assert float(tm["overflow"]) == 0


def _mapping_pair(scene, n_it, two_views, cfg_kw):
    sc, jf, tf = scene
    colors, monodeps = np.asarray(sc.colors), np.asarray(sc.monodeps)
    w2c = np.asarray(sc.gt_w2c)
    jst, jaux = js.mapping_chunk(
        _jstate(jf), jnp.asarray(colors), jnp.asarray(monodeps),
        jnp.asarray(w2c), jnp.full((n_it,), 1, jnp.int32),
        jnp.zeros((2,), jnp.int32), jnp.int32(1), sc.cam,
        js.TrainConfig(impl="pallas_interpret", max_instances=MAXI,
                       densify=jd.DensifyConfig(percent_dense=100.0),
                       **cfg_kw), two_views, 1)
    cfg = ts.TrainConfig(densify=td.DensifyConfig(percent_dense=100.0),
                         **cfg_kw)
    rc.reset_bins()
    tst, taux = ts.mapping_chunk(
        _tstate(tf), torch.tensor(colors), torch.tensor(monodeps),
        torch.tensor(w2c), [1] * n_it, [0], tcam(sc.cam), cfg, two_views, 1)
    bins = rc.BINS["build_tile_bins"]
    np.testing.assert_allclose(float(jaux["loss"]), float(taux["loss"]),
                               rtol=1e-4)
    for k in PARAMS:
        close_params(getattr(jst.field, k), getattr(tst.field, k), k,
                     atol=1e-4, bulk=5e-5)
    np.testing.assert_array_equal(np.asarray(jst.field.active),
                                  tst.field.active.numpy())
    assert float(taux["overflow_max"]) == 0
    return cfg, taux, bins


def test_mapping_chunk_rebin_every_3_with_densify(scene):
    """One view, 4 iterations, densify (clones only: percent_dense is set
    so that no Gaussian splits, whose noise the packages draw differently)
    at iteration 2: the carry rebins at k = 0, 2 (forced) and 3."""
    cfg_kw = dict(w_local_pearson=0.0, rebin_every=3, densify_interval=2,
                  densify_until=3, opacity_reset_interval=1000)
    cfg, taux, bins = _mapping_pair(scene, 4, False, cfg_kw)
    assert taux["densify_events"] == 1
    assert float(taux["densify_totals"]["cloned"]) > 0
    assert float(taux["densify_totals"]["split"]) == 0
    assert bins == expected_bins([1] * 4, 0, cfg) == 3
    assert taux["keyframe_views"] is None


def test_mapping_chunk_two_views_sorted_keyframes(scene):
    """Two views with keyframes [0] (every draw is frame 0): the keyframe
    view carries its own layout; both views rebin at k = 0 and 2."""
    cfg_kw = dict(w_local_pearson=0.0, rebin_every=2, densify_interval=1000,
                  opacity_reset_interval=1000)
    cfg, taux, bins = _mapping_pair(scene, 3, True, cfg_kw)
    assert taux["keyframe_views"].tolist() == [0, 0, 0]
    assert bins == 2 * expected_bins([1] * 3, 0, cfg) == 4


@pytest.mark.parametrize("rebin_every", [1, 3])
def test_global_run_visits_sorted_draws(monkeypatch, rebin_every):
    """global_run draws each chunk from default_rng(seed + 1) and, with
    rebin_every > 1, visits the draws in sorted order."""
    from freesurgs_tpu_torch.data.synthetic import SceneSequence, make_scene
    sc = make_scene(num_frames=3, n_gaussians=100, height=32, width=48,
                    seed=2, device="cpu")
    tr = tloop.Trainer(SceneSequence(sc),
                       ts.TrainConfig(rebin_every=rebin_every), seed=11,
                       sh_degree_max=0, capacity=1024, global_chunk=5,
                       validation_every=0, log_fn=lambda *a: None,
                       device="cpu")
    seen = []
    real = tloop.mapping_chunk

    def spy(state, *a, **kw):
        seen.append(list(a[3]))
        return real(state, *a, **kw)

    monkeypatch.setattr(tloop, "mapping_chunk", spy)
    tr.global_run(8)
    rng = np.random.default_rng(12)
    want = [rng.choice(np.arange(3), size=n) for n in (5, 3)]
    if rebin_every > 1:
        want = [np.sort(w) for w in want]
    assert seen == [w.tolist() for w in want]
