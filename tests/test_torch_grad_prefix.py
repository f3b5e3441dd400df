"""The JAX package's default backward reduction in the port
(``RasterConfig.grad_sum="prefix"``, the counterpart of ``fast_binning=True``
in ``freesurgs_tpu/ops/raster_pallas.py:737-756``) against the JAX package:

(a) the layout's byproducts, ``build_tile_bins(pre_slots=True)``'s
    ``pre_rank`` / ``seg_lo`` / ``seg_hi``, against ``BinAux`` of JAX
    ``build_tile_bins_fast(..., return_aux=True)`` element for element, at
    capacities that drop instances too. JAX marks a pre-slot that holds no
    kept instance (dropped at the cap, or past the expansion) with the
    sentinel ``pos == M`` and reads a zero row there; the port maps a
    padding slot to it, whose row the backward writes as +0;
(b) ``blocked_scan_plain`` against ``jnp.cumsum`` under jit, bitwise, 1-D
    and (M, 10), at lengths around the block of 16 and past 16^4 rows
    (5 levels); and the reduction's decomposition, which the kernel shares
    (each csum value rebuilt top-down from the levels' block scans),
    bitwise ``blocked_scan_plain`` then the two lookups, on tilings with
    empty and one-row runs;
(c) the reduction (``gaussian_grad_prefix``, its plain version on the CPU)
    against JAX's ``_composite_bwd`` fast branch on the same (10, M) rows,
    bitwise: JAX's kernels are stubbed to hand its reduction those rows.
    A Gaussian of large gradients first in depth order makes the direct
    sum part from it by more than 1e-4 normalized, so the test tells the
    two reductions apart;
(d) one render's gradients through ``rasterize`` with "prefix" against
    ``rasterize_pallas`` with ``fast_binning=True`` in interpret mode,
    fresh and on a carried layout, at the JAX package's oracle-vs-Pallas
    gates (pixels 2e-5, gradients 5e-5 normalized);
(e) the slice: ``mapping_chunk`` (the layout carry, a densify event) with
    ``grad_sum="prefix"`` against the JAX chunk, whose renders take the
    fast binner by default, at the port's Trainer-step gates
    (tests/test_torch_bin_reuse.py);
and the switch's refusals: an unknown value, a "prefix" render on a
layout binned without pre-slots; and a one-rank mesh's band-sharded
"prefix" render, the single render (the bands' case is in
tests/test_torch_parallel.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.ops import binning_fast, raster_pallas
from freesurgs_tpu.ops.raster_pallas import RasterConfig as JRC, \
    compute_bin_state, rasterize_pallas
from freesurgs_tpu.train import densify as jd
from freesurgs_tpu.train import steps as js
from freesurgs_tpu_torch.data.synthetic import make_scene
from freesurgs_tpu_torch.ops import raster_cuda as rc
from freesurgs_tpu_torch.ops.binning import build_tile_bins, derive_bin_rect
from freesurgs_tpu_torch.ops.projection import ProjectedGaussians
from freesurgs_tpu_torch.ops.render import render
from freesurgs_tpu_torch.parallel.mesh import make_mesh
from freesurgs_tpu_torch.parallel.sharded import render_sharded_full
from freesurgs_tpu_torch.train import densify as td
from freesurgs_tpu_torch.train import steps as ts

from test_torch_bin_reuse import MAXI, _jstate, _tstate
from test_torch_binning import GX, GY, jderive, jsnug, make, to_torch
from test_torch_raster import compare, scene as raster_scene
from test_torch_train import PARAMS, close_params, scene, tcam  # noqa: F401

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

jfast_aux = jax.jit(binning_fast.build_tile_bins_fast,
                    static_argnums=(1, 2, 3, 4))
jcumsum = jax.jit(lambda x: jnp.cumsum(x, axis=0))
jbin_state = jax.jit(compute_bin_state, static_argnums=2)


def eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def port_bins(proj, opac, cap, grid=(GX, GY)):
    tb = derive_bin_rect(rc._prune_and_snug(to_torch(proj),
                                            torch.tensor(opac)), 2)
    return build_tile_bins(tb, *grid, cap, pre_slots=True)


# ----------------------------------------------------------------- (a)

@pytest.mark.parametrize("n,seed,cap", [
    (60, 1, 1 << 20), (400, 2, 1 << 20), (1500, 3, 1 << 20),
    (900, 4, 128), (900, 4, 512), (900, 4, 1000)])
def test_pre_slots_equal_jax_bin_aux(n, seed, cap):
    proj, opac = make(n, seed)
    jb = jderive(jsnug(proj, jnp.asarray(opac)), 2)
    t = port_bins(proj, opac, cap)
    m = t.gather_idx.shape[0]
    bins, aux = jfast_aux(jb, GX, GY, m, True)
    eq(bins.gather_idx, t.gather_idx)          # the same layout
    eq(aux.seg_lo, t.seg_lo)
    eq(aux.seg_hi, t.seg_hi)
    pre_rank = t.pre_rank.numpy().astype(np.int64)
    assert np.array_equal(np.sort(pre_rank), np.arange(m))  # a permutation
    slot_of = np.empty(m, np.int64)
    slot_of[pre_rank] = np.arange(m)            # pre-slot -> slot
    pos = np.asarray(aux.pos)
    held = pos < m
    np.testing.assert_array_equal(slot_of[held], pos[held])
    # JAX's sentinel m <-> a padding slot of the port (row +0)
    gidx = t.gather_idx.numpy()
    assert np.all(gidx[slot_of[~held]] == n)
    expanded = int(t.seg_hi.max())
    if int(t.overflow) > 0:
        # instances of the expansion dropped at the cap: JAX reads zeros
        # there, inside their Gaussians' runs
        assert np.any(~held[:expanded])
    # the runs tile the expansion kept at this capacity
    lo, hi = t.seg_lo.numpy(), t.seg_hi.numpy()
    runs = np.sort(np.stack([lo, hi], 1)[hi > lo], axis=0)
    assert runs[0, 0] == 0 and runs[-1, 1] == expanded
    np.testing.assert_array_equal(runs[1:, 0], runs[:-1, 1])


# ----------------------------------------------------------------- (b)

def wide(rng, shape):
    """f32 values over ~8 decades, both signs: rounding in every add."""
    x = rng.standard_normal(shape) * np.exp(3.0 * rng.standard_normal(
        shape[:1] + (1,) * (len(shape) - 1)))
    return x.astype(np.float32)


@pytest.mark.parametrize("length", [1, 15, 16, 17, 257, 4099, 65537,
                                    100003])
def test_blocked_scan_is_jnp_cumsum(length):
    rng = np.random.default_rng(length)
    x = wide(rng, (length, 10))
    want = np.asarray(jcumsum(jnp.asarray(x)))
    got = rc.blocked_scan_plain(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want1 = np.asarray(jcumsum(jnp.asarray(x[:, 3])))
    got1 = rc.blocked_scan_plain(torch.tensor(x[:, 3:4]))[:, 0].numpy()
    np.testing.assert_array_equal(got1.view(np.int32), want1.view(np.int32))
    assert rc.scan_levels(length) == (
        [] if length <= 16 else [-(-length // 16)] + rc.scan_levels(
            -(-length // 16)))


def test_scan_levels_of_the_full_width_layout():
    assert rc.scan_levels(824_341) == [51_522, 3_221, 202, 13]


def runs(rng, m, n):
    """Runs [lo, hi) tiling [0, m), shuffled: empty ones (at 0 and at m
    too), one-row ones and longer ones."""
    one = rng.integers(0, m, 2)
    b = np.sort(np.concatenate([rng.integers(0, m + 1, n), [0, 0, m, m],
                                one, one + 1]))
    lo, hi = b[:-1], b[1:]
    assert np.any(hi == lo) and np.any(hi - lo == 1)
    order = rng.permutation(len(lo))
    return (torch.tensor(lo[order], dtype=torch.int32),
            torch.tensor(hi[order], dtype=torch.int32))


@pytest.mark.parametrize("length", [15, 16, 17, 255, 256, 257, 4095, 4096,
                                    4097, 16 ** 4 + 1])
def test_decomposition_is_scan_then_lookup(length):
    rng = np.random.default_rng(length + 7)
    x = wide(rng, (length, 10))
    x[rng.random(length) < 0.05] = -0.0
    pre = torch.tensor(x)
    lo, hi = runs(rng, length, max(12, length // 3))
    csum = torch.cat([pre.new_zeros(1, 10), rc.blocked_scan_plain(pre)])
    want = (csum[hi.long()] - csum[lo.long()]).numpy()
    got = rc.gaussian_grad_prefix(pre, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    levels = rc.block_scans(pre)
    assert [lv.shape[0] for lv in levels[1:]] == rc.scan_levels(length)
    k = torch.arange(length + 1)
    np.testing.assert_array_equal(
        rc.prefix_csum_at(levels, k).numpy().view(np.int32),
        csum.numpy().view(np.int32))


# ----------------------------------------------------------------- (c)

def jax_fast_branch(monkeypatch, proj, rgbz, opac, cfg, state, rows):
    """JAX's ``_composite_bwd`` with ``fast_binning=True`` on ``state``,
    its kernels stubbed: the backward kernel's output is ``rows`` (10, M)
    in slot order. Returns its (n, 10) per-Gaussian sums."""
    m = rows.shape[1]
    dfeat = jnp.asarray(np.concatenate(
        [rows, np.zeros((raster_pallas.FEAT_DIM - 10, m), np.float32)]))
    monkeypatch.setattr(raster_pallas, "_run_fwd", lambda feat, meta, c: (
        jnp.zeros((c.num_tiles, c.npix, raster_pallas.N_OUT)),
        jnp.zeros((c.num_tiles,), jnp.int32)))
    monkeypatch.setattr(raster_pallas, "_run_bwd", lambda *a: dfeat)

    def f(mean2d, conic, rgbz_, opac_):
        out = rasterize_pallas(proj._replace(mean2d=mean2d, conic=conic),
                               rgbz_, opac_, cfg, bins=state)
        return out["image"]

    args = [proj.mean2d, proj.conic, jnp.asarray(rgbz), jnp.asarray(opac)]
    img, vjp = jax.vjp(jax.jit(f), *args)
    g = vjp(jnp.ones_like(img))
    return np.concatenate([np.asarray(g[0]), np.asarray(g[1]),
                           np.asarray(g[3])[:, None], np.asarray(g[2])], 1)


def test_reduction_bitwise_jax_fast_branch(monkeypatch):
    cam, proj, rgbz, opac, _, _ = raster_scene(300, 64, 96, 11)
    n = 300
    p = ProjectedGaussians(*(torch.tensor(np.asarray(x)) for x in proj))
    cfg = rc.RasterConfig(64, 96, 1 << 20, "prefix")
    _, _, bins = rc.instance_records(p, torch.tensor(rgbz),
                                     torch.tensor(opac), cfg)
    m = bins.gather_idx.shape[0]
    jcfg = JRC(height=64, width=96, max_instances=m, interpret=True,
               bin_tile=32)
    state = jbin_state(proj, jnp.asarray(opac), jcfg)
    eq(state.gather_idx, bins.gather_idx)

    rng = np.random.default_rng(3)
    rows = rng.standard_normal((10, m)).astype(np.float32)
    gidx = bins.gather_idx.numpy()
    rows[:, gidx == n] = 0.0                   # K2's padding rows
    # the Gaussian first in depth order: gradients 1e4 times the others'
    first = int(np.flatnonzero(bins.seg_lo.numpy() == 0)[
        np.argmax(bins.seg_hi.numpy()[bins.seg_lo.numpy() == 0])])
    assert int(bins.seg_hi[first]) >= 4
    rows[:, gidx == first] *= 1e4

    want = jax_fast_branch(monkeypatch, proj, rgbz, opac, jcfg, state, rows)
    pre = torch.zeros(m, 10)
    pre[bins.pre_rank.long()] = torch.tensor(rows.T)
    got = rc.gaussian_grad_prefix(pre, bins.seg_lo, bins.seg_hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    # the port's direct sum on the same rows is another reduction
    dsum = torch.empty(m, 10)
    dsum[bins.sum_rank.long()] = torch.tensor(rows.T)
    direct = rc.gaussian_grad_sum(dsum, bins.sum_start).numpy()
    others = np.arange(n) != first
    scale = np.abs(direct[others]).max(axis=0)
    err = (np.abs(direct - want)[others] / scale).max()
    assert err > 1e-4, err


# ----------------------------------------------------------------- (d)

def port_prefix(cam, proj, bins=None):
    cfg = rc.RasterConfig(cam.height, cam.width, 1 << 20, "prefix")

    def f(mean2d, conic, rgbz, opac):
        p = ProjectedGaussians(mean2d, conic,
                               *(torch.tensor(np.asarray(x))
                                 for x in proj[2:]))
        out = rc.rasterize(p, rgbz, opac, cfg, bins=bins)
        assert out["bins"].pre_rank is not None
        return out["image"], out["final_T"], out["overflow"]
    return f


def jax_fast(cam, proj, state=None):
    def f(mean2d, conic, rgbz, opac):
        cfg = JRC(height=cam.height, width=cam.width, max_instances=8192,
                  interpret=True, bin_tile=32, fast_binning=True)
        out = rasterize_pallas(proj._replace(mean2d=mean2d, conic=conic),
                               rgbz, opac, cfg, bins=state)
        return out["image"], out["final_T"]
    return f


def test_render_matches_jax_fast_path_fresh_and_carried():
    cam, proj, rgbz, opac, g_img, g_T = raster_scene(150, 32, 64, 0)
    compare(jax_fast(cam, proj), port_prefix(cam, proj), proj, rgbz, opac,
            g_img, g_T)
    # a layout binned on these projections, carried to moved means
    state = jbin_state(proj, jnp.asarray(opac),
                       JRC(height=32, width=64, max_instances=8192,
                           interpret=True, bin_tile=32))
    p = ProjectedGaussians(*(torch.tensor(np.asarray(x)) for x in proj))
    carried = rc.rasterize(p, torch.tensor(rgbz), torch.tensor(opac),
                           rc.RasterConfig(32, 64, 1 << 20, "prefix"))["bins"]
    moved = proj._replace(mean2d=proj.mean2d + 0.25)
    compare(jax_fast(cam, moved, state), port_prefix(cam, moved, carried),
            moved, rgbz, opac, g_img, g_T)


# ----------------------------------------------------------------- (e)

def test_mapping_chunk_prefix_with_densify(scene):
    """One view, 3 iterations, the carry rebinning at k = 0 and 2 (after a
    densify event), the layouts carrying their pre-slots."""
    sc, jf, tf = scene
    colors, monodeps = np.asarray(sc.colors), np.asarray(sc.monodeps)
    w2c = np.asarray(sc.gt_w2c)
    kw = dict(w_local_pearson=0.0, rebin_every=3, densify_interval=2,
              densify_until=3, opacity_reset_interval=1000)
    jst, jaux = js.mapping_chunk(
        _jstate(jf), jnp.asarray(colors), jnp.asarray(monodeps),
        jnp.asarray(w2c), jnp.full((3,), 1, jnp.int32),
        jnp.zeros((2,), jnp.int32), jnp.int32(1), sc.cam,
        js.TrainConfig(impl="pallas_interpret", max_instances=MAXI,
                       densify=jd.DensifyConfig(percent_dense=100.0), **kw),
        False, 1)
    tst, taux = ts.mapping_chunk(
        _tstate(tf), torch.tensor(colors), torch.tensor(monodeps),
        torch.tensor(w2c), [1] * 3, [0], tcam(sc.cam),
        ts.TrainConfig(densify=td.DensifyConfig(percent_dense=100.0),
                       grad_sum="prefix", **kw), False, 1)
    assert taux["densify_events"] == 1
    np.testing.assert_allclose(float(jaux["loss"]), float(taux["loss"]),
                               rtol=1e-4)
    for k in PARAMS:
        close_params(getattr(jst.field, k), getattr(tst.field, k), k,
                     atol=1e-4, bulk=5e-5)


# ------------------------------------------------------------- refusals

def test_switch_refuses_what_it_does_not_run():
    cam, proj, rgbz, opac, _, _ = raster_scene(100, 64, 64, 2)
    p = ProjectedGaussians(*(torch.tensor(np.asarray(x)) for x in proj))
    args = (p, torch.tensor(rgbz), torch.tensor(opac))
    with pytest.raises(ValueError, match="grad_sum"):
        rc.rasterize(*args, rc.RasterConfig(64, 64, 1 << 20, "sorted"))
    direct = rc.rasterize(*args, rc.RasterConfig(64, 64, 1 << 20))["bins"]
    assert direct.pre_rank is None
    with pytest.raises(ValueError, match="binned"):
        rc.rasterize(*args, rc.RasterConfig(64, 64, 1 << 20, "prefix"),
                     bins=direct)
    with pytest.raises(ValueError, match="grad_sum"):
        ts.check_supported(ts.TrainConfig(grad_sum="sorted"))


def test_one_rank_mesh_prefix_is_the_single_render():
    """A band-sharded "prefix" render on a one-rank mesh (no group: the
    band's sum is the whole) is ``render``'s "prefix" render, bit for bit,
    gradients included."""
    sc = make_scene(num_frames=2, n_gaussians=120, height=48, width=64,
                    seed=4, device="cpu")
    mesh = make_mesh(device="cpu")

    def grads(fn):
        p = [t.detach().clone().requires_grad_(True) for t in
             (sc.means, sc.quats, sc.log_scales, sc.logit_opacity, sc.sh)]
        out = fn(*p, sc.gt_w2c[0], sc.cam, max_instances=1 << 16,
                 grad_sum="prefix")
        loss = (out["render"] * torch.linspace(-1, 1, 64)).sum() \
            + out["render_dep"].sum()
        return [out["render"], out["render_dep"]] + list(
            torch.autograd.grad(loss, p))

    for a, b in zip(grads(functools.partial(render_sharded_full, mesh)),
                    grads(render)):
        assert torch.equal(a, b)
