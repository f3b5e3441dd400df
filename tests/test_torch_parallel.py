"""``freesurgs_tpu_torch.parallel`` against the JAX package's ``parallel``:
band-sharded rendering and its gradients, ``render_sharded``,
``sharded_train_step``, ``mapping_chunk(mesh=)``, ``tracking_loop(mesh=)``,
``multiseq_mapping_chunk`` and a ``Trainer(mesh=)``.

The port runs in 4 spawned ranks of a gloo group on the CPU
(tests/torch_parallel_worker.py, one thread each, one spawn for the module)
on 1 x 4, 2 x 2 and 4 x 1 meshes, and after those the port's
single-process functions on the same inputs; the JAX side runs here, on
the 8-device virtual CPU mesh with the dense oracle, while the ranks work.
Scenes: 64x64 with 150 (90 under ``shard_projection``)
Gaussians, so 2 bands are 32 rows high and 4 bands 16 rows, half of the
port's 32 px bin; the sequences 32x48.

The same renders and a mapping chunk also run with ``grad_sum="prefix"``
(each band reduces by its own prefix sum, the bands' sums all-reduced, as
JAX's bands do); on 2 bands each rank's band layout is held element for
element to the JAX fast binner's on that band's records, and the
all-reduced sums to the sum of the bands' own.

Tolerances: pixels 2e-5; gradients 5e-5 of each field's largest
(normalized, K2's gate); ``grad_denom`` and radii exact; parameters after
3 mapping steps 1e-3, logit_opacity 1e-2 (JAX's tests/test_sharded.py:
Adam turns gradient rounding into steps of a fraction of the LR); tracking
poses 1e-3; SGD parameters 1e-6 (3 steps of LR 5e-3 on gradients within
5e-5); the multi-sequence states bitwise the port's single runs; the ranks
bitwise equal to each other; the Trainer on a mesh within the Trainer gate
of tests/test_torch_train.py (1e-3, 99% of entries 1e-5) of one without.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.ops.projection import ProjectedGaussians as JProj
from freesurgs_tpu.models.gaussians import GaussianField as JField
from freesurgs_tpu.parallel import sharded as jsh
from freesurgs_tpu.parallel.mesh import make_mesh as jmesh
from freesurgs_tpu.train import steps as js
from freesurgs_tpu.train.optim import adam_init as jadam_init
from freesurgs_tpu_torch.data.synthetic import make_scene
from freesurgs_tpu_torch.parallel import sharded as tsh

import torch_parallel_worker as wk
from test_torch_binning import jderive, jsnug
from test_torch_grad_prefix import jfast_aux
from test_torch_train import close_params
from test_torch_viz import one_thread  # noqa: F401 (autouse fixture)

PIX_TOL = 2e-5
GRAD_TOL = 5e-5
PARAM_TOL, OPACITY_TOL, POSE_TOL, SGD_TOL = 1e-3, 1e-2, 1e-3, 1e-6
CAM = (64, 64, 60.0, 60.0, 32.0, 32.0)
GRAD_KEYS = wk.PARAM_KEYS + ("probe", "w2c")


def jcam(a):
    h, w, fx, fy, cx, cy = a
    return JCam(height=int(h), width=int(w), fx=float(fx), fy=float(fy),
                cx=float(cx), cy=float(cy))


def cam_array(cam):
    return np.asarray([cam.height, cam.width, cam.fx, cam.fy, cam.cx,
                       cam.cy], np.float64)


def gaussians(rng, n):
    """tests/test_sharded.py's scene."""
    means = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(0.6, 3.0, n)], -1)
    return {"means": means, "quats": rng.normal(size=(n, 4)),
            "log_scales": rng.uniform(-4, -2, (n, 3)),
            "logit_opacity": rng.uniform(-1, 3, n),
            "sh": rng.normal(size=(n, 1, 3)) * 0.3}


def field_arrays(sc, cap, perturb, seed):
    """tests/test_training_steps.py's field_from_scene, in numpy."""
    rng = np.random.default_rng(seed)
    n = sc.means.shape[0]
    means, sh = sc.means.numpy(), sc.sh.numpy()
    means = means + rng.normal(size=means.shape).astype(np.float32) * perturb
    sh = sh + rng.normal(size=sh.shape).astype(np.float32) * perturb * 3

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    quats = pad(sc.quats.numpy())
    quats[n:, 0] = 1.0
    return dict(means=pad(means), quats=quats,
                log_scales=pad(sc.log_scales.numpy()),
                logit_opacity=pad(sc.logit_opacity.numpy()),
                sh_dc=pad(sh[:, :1]), sh_rest=np.zeros((cap, 0, 3), np.float32),
                active=np.arange(cap) < n,
                max_radii2d=np.zeros(cap, np.float32),
                grad_accum=np.zeros(cap, np.float32),
                grad_denom=np.zeros(cap, np.float32),
                scene_radius=np.float32(1.5))


def make_inputs():
    rng = np.random.default_rng(0)
    inp = {"cam": np.asarray(CAM)}
    for prefix, n in (("p_", 150), ("q_", 90)):
        inp.update({prefix + k: v.astype(np.float32)
                    for k, v in gaussians(rng, n).items()})
    inp.update(w_rgb=rng.normal(size=(3, 64, 64)),
               w_dep=rng.normal(size=(64, 64)),
               w_T=rng.normal(size=(64, 64)),
               target=rng.uniform(size=(3, 64, 64)))
    sc = make_scene(num_frames=2, n_gaussians=150, height=64, width=64,
                    seed=9, device="cpu")
    inp.update(m_cam=cam_array(sc.cam), m_colors=sc.colors.numpy(),
               m_monodeps=sc.monodeps.numpy(), m_w2c=sc.gt_w2c.numpy(),
               m_depth0=sc.depths[0].numpy(), m_flow0=sc.flows_fw[0].numpy(),
               m_q0=sc.gt_quats[0].numpy(), m_t0=sc.gt_trans[0].numpy())
    inp.update({"mf_" + k: v
                for k, v in field_arrays(sc, 256, 0.01, 0).items()})
    seqs = [make_scene(num_frames=2, n_gaussians=200, height=32, width=48,
                       seed=s, device="cpu") for s in range(1, wk.WORLD + 1)]
    inp.update(s_cam=cam_array(seqs[0].cam),
               s_colors=np.stack([s.colors.numpy() for s in seqs]),
               s_monodeps=np.stack([s.monodeps.numpy() for s in seqs]),
               s_w2c=np.stack([s.gt_w2c.numpy() for s in seqs]))
    for i, s in enumerate(seqs):
        inp.update({f"sf{i}_{k}": v
                    for k, v in field_arrays(s, 512, 0.01, i).items()})
    sc = make_scene(num_frames=2, n_gaussians=300, height=32, width=48,
                    seed=5, device="cpu")
    inp.update(tr_cam=cam_array(sc.cam), tr_colors=sc.colors.numpy(),
               tr_monodeps=sc.monodeps.numpy(), tr_flows=sc.flows_fw.numpy())
    return {k: (v.astype(np.float32) if v.dtype == np.float64
                and k[-3:] != "cam" else v) for k, v in inp.items()}


def jax_references(inp):
    """The JAX package's functions on its 8-device virtual CPU mesh, each
    under one jit, with the dense oracle; the independent ones compile in
    threads of their own."""
    cam = jcam(inp["cam"])
    w = [jnp.asarray(inp[k]) for k in ("w_rgb", "w_dep", "w_T")]

    def params(prefix):
        return {k: jnp.asarray(inp[prefix + k]) for k in wk.PARAM_KEYS}

    def grads_of(prefix, n_bands, sp):
        mesh = jmesh(n_bands)
        p = params(prefix)
        n = p["means"].shape[0]

        def loss(p, probe, w2c):
            o = jsh.render_sharded_full(
                mesh, *(p[k] for k in wk.PARAM_KEYS), w2c, cam,
                probe2d=probe, impl="oracle", shard_projection=sp)
            return (jnp.sum(o["render"] * w[0])
                    + jnp.sum(o["render_dep"] * w[1])
                    + jnp.sum(o["final_T"] * w[2])), o

        (_, o), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                p, jnp.zeros((n, 2)), jnp.eye(4))
        out = {k: np.asarray(o[k]) for k in ("render", "render_dep",
                                             "final_T", "radii")}
        out.update({f"g_{k}": np.asarray(g[0][k]) for k in wk.PARAM_KEYS})
        out.update(g_probe=np.asarray(g[1]), g_w2c=np.asarray(g[2]))
        return out

    def render_sharded():
        mesh4 = jmesh(4)
        return {k: np.asarray(v) for k, v in jax.jit(
            lambda p: jsh.render_sharded(
                mesh4, *(p[k] for k in wk.PARAM_KEYS), jnp.eye(4), cam,
                impl="oracle"))(params("p_")).items() if k != "pad_height"}

    def train_steps():
        mesh4 = jmesh(4)
        target = jnp.asarray(inp["target"])
        step = jax.jit(lambda pp: jsh.sharded_train_step(
            mesh4, pp, jnp.eye(4), target, cam, lr=5e-3))
        p, losses = params("p_"), []
        for _ in range(3):
            p, loss = step(p)
            losses.append(float(loss))
        return {"loss": np.asarray(losses),
                **{k: np.asarray(v) for k, v in p.items()}}

    mcam = jcam(inp["m_cam"])
    field = JField(**{k: jnp.asarray(v)
                      for k, v in wk.field_arrays(inp, "mf_").items()},
                   max_sh_degree=0)

    def mapping():
        st = js.MappingState(field, jadam_init(field.param_dict()),
                             jnp.int32(0), jax.random.PRNGKey(0),
                             jnp.zeros((2, 64, 64)),
                             jnp.zeros((2, 3, 64, 64)))
        st, aux = js.mapping_chunk(
            st, jnp.asarray(inp["m_colors"]), jnp.asarray(inp["m_monodeps"]),
            jnp.asarray(inp["m_w2c"]), jnp.zeros((3,), jnp.int32),
            jnp.zeros((2,), jnp.int32), jnp.int32(1), cam=mcam,
            cfg=js.TrainConfig(impl="oracle", **wk.MAP_CFG),
            two_views=False, sh_degree=0, densify_enabled=True,
            mesh=jmesh(4))
        return {"loss": float(aux["loss"]),
                **{k: np.asarray(getattr(st.field, k))
                   for k in wk.FIELD_OUT}}

    def tracking():
        q, t, met = js.tracking_loop(
            field, jnp.asarray(inp["m_q0"]), jnp.asarray(inp["m_t0"]),
            jnp.asarray(inp["m_colors"][1]), jnp.asarray(inp["m_depth0"]),
            jnp.asarray(inp["m_w2c"][0]), jnp.asarray(inp["m_flow0"]),
            jnp.ones((64, 64)), mcam,
            js.TrainConfig(impl="oracle", **wk.TRACK_CFG), mesh=jmesh(2))
        return {"q": np.asarray(q), "t": np.asarray(t),
                "loss": float(met["loss"])}

    jobs = {"b2": lambda: grads_of("p_", 2, False),
            "b4": lambda: grads_of("p_", 4, False),
            "sp": lambda: grads_of("q_", 4, True),
            "rs": render_sharded, "sts": train_steps, "map": mapping,
            "trk": tracking}
    with ThreadPoolExecutor(max_workers=4) as ex:
        futures = {k: ex.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 4 ranks, compute the JAX references while they run, then
    read every rank's results."""
    d = tmp_path_factory.mktemp("parallel")
    inp = make_inputs()
    np.savez(d / "inputs.npz", **inp)
    ctx = tmp.start_processes(
        wk.main, args=(str(d / "init"), str(d / "inputs.npz"), str(d)),
        nprocs=wk.WORLD, join=False, start_method="spawn")
    try:
        jref = jax_references(inp)
    finally:
        while not ctx.join(timeout=120):
            pass
    ranks = []
    for r in range(wk.WORLD):
        with np.load(d / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return {"inp": inp, "jax": jref, "ranks": ranks, "dir": d}


def close_grads(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_TOL,
                               err_msg=name)


def close_render(got, want, prefix, want_prefix=""):
    for k in ("render", "render_dep", "final_T"):
        np.testing.assert_allclose(got[prefix + k], want[want_prefix + k],
                                   atol=PIX_TOL, err_msg=k)
    np.testing.assert_array_equal(got[prefix + "radii"],
                                  want[want_prefix + "radii"])
    for k in GRAD_KEYS:
        close_grads(got[f"{prefix}g_{k}"], want[f"{want_prefix}g_{k}"], k)


# ------------------------------------------------------------ in-process

@pytest.mark.parametrize("height,n", [(64, 2), (64, 4), (48, 2), (1024, 2),
                                      (100, 3)])
def test_pad_height_for(height, n):
    """Padded heights exactly JAX's."""
    cam = wk.camera(np.asarray([height, 64, 60, 60, 32, 32]))
    want = jsh.pad_height_for(jcam((height, 64, 60, 60, 32, 32)), n)
    assert tsh.pad_height_for(cam, n).height == want.height
    assert tsh.band_instance_cap(4096, n) == max(-(-4096 // n // 128) * 128,
                                                 128)


@pytest.mark.parametrize("b", [0, 1, 3])
def test_clip_to_band(b):
    """A band's records exactly JAX's: rects crossing, inside and outside
    the band, culled ones (zero rects), 16 px bands."""
    rng = np.random.default_rng(b)
    n, band_h, gty = 64, 16, 1
    mean2d = rng.uniform(-10, 80, (n, 2)).astype(np.float32)
    lo = rng.integers(0, 4, (n, 2))
    rect = np.concatenate([lo, lo + rng.integers(0, 3, (n, 2))],
                          1).astype(np.int32)
    rect[::7] = 0
    touched = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
               ).astype(np.int32)
    radius = np.where(touched > 0, rng.integers(1, 9, n), 0).astype(np.int32)
    want = jsh._clip_to_band(jnp.int32(b), band_h, gty, jnp.asarray(mean2d),
                             jnp.asarray(rect), jnp.asarray(touched),
                             jnp.asarray(radius))
    got = tsh._clip_to_band(b, band_h, gty, torch.tensor(mean2d),
                            torch.tensor(rect), torch.tensor(touched),
                            torch.tensor(radius))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("split", [0, 37, 200])
def test_band_sum_continues_the_single_sum(split):
    """The premise of the band-to-band gradient sum: a layout's slots in
    two parts (two bands' runs), the second's per-Gaussian sums seeded
    with the first's, give the whole layout's sums bit for bit."""
    from freesurgs_tpu_torch.ops.binning import sum_layout
    from freesurgs_tpu_torch.ops.raster_cuda import gaussian_grad_sum
    rng = np.random.default_rng(split)
    n, m = 40, 200
    gather = torch.tensor(rng.integers(0, n + 1, m))    # n: padding
    rows = torch.tensor(rng.normal(size=(m, 10)).astype(np.float32))

    def sums(slots, init=None):
        _, start, rank = sum_layout(gather[slots], n)
        dsum = torch.empty(len(slots), 10)
        dsum[rank.long()] = rows[slots]
        return gaussian_grad_sum(dsum, start, init=init)

    whole = sums(np.arange(m))
    first = sums(np.arange(split))
    assert torch.equal(sums(np.arange(split, m), init=first), whole)


# ------------------------------------------------------------- the ranks

@pytest.mark.parametrize("name", ["b2", "b4", "sp"])
def test_sharded_render_matches_jax(run, name):
    """2 and 4 bands (the 4-band case: 16 px bands), and 4 bands with the
    projection sharded over N (90 Gaussians: a padded chunk): images,
    radii and every gradient (parameters, probe, pose) against JAX
    ``render_sharded_full(impl="oracle")``."""
    close_render(run["ranks"][0], run["jax"][name], f"{name}_")


@pytest.mark.parametrize("name", ["b2", "b4", "sp"])
def test_sharded_prefix_render_matches_jax(run, name):
    """The same with ``grad_sum="prefix"`` (each band's prefix reduction,
    the bands' sums all-reduced) against JAX ``render_sharded_full(impl=
    "oracle")``: the reduction moves no gradient past the file's gates."""
    close_render(run["ranks"][0], run["jax"][name], f"p{name}_")


@pytest.mark.parametrize("rank", range(4))
def test_prefix_band_layout_is_jax_bin_aux(run, rank):
    """On the 2 x 2 mesh (32-row bands, one bin high) each band's pre-slot
    layout, binned from the band's clipped records as the rank rendered
    it, equals JAX ``build_tile_bins_fast(..., return_aux=True)`` on those
    records element for element; and the all-reduced sums are the rank-
    order sum of the two bands' own prefix sums, bitwise."""
    with np.load(run["dir"] / f"prefix_band{rank}.npz") as f:
        band = {k: f[k] for k in f.files}
    proj = JProj(*(jnp.asarray(band[k]) for k in JProj._fields))
    m = band["gather_idx"].shape[0]
    gx = -(-int(band["width"]) // 32)
    gy = -(-int(band["height"]) // 32)
    assert gy == 1 and int(band["overflow"]) == 0
    bins, aux = jfast_aux(jderive(jsnug(proj, jnp.asarray(band["opacity"])),
                                  2), gx, gy, m, True)
    np.testing.assert_array_equal(np.asarray(bins.gather_idx),
                                  band["gather_idx"])
    np.testing.assert_array_equal(np.asarray(aux.seg_lo), band["seg_lo"])
    np.testing.assert_array_equal(np.asarray(aux.seg_hi), band["seg_hi"])
    slot_of = np.empty(m, np.int64)
    slot_of[band["pre_rank"]] = np.arange(m)      # pre-slot -> slot
    pos = np.asarray(aux.pos)
    held = pos < m
    np.testing.assert_array_equal(slot_of[held], pos[held])
    n = band["opacity"].shape[0]
    assert np.all(band["gather_idx"][slot_of[~held]] == n)
    # the two bands of this rank's data row, in rank order
    first = rank - rank % 2
    parts = []
    for r in (first, first + 1):
        with np.load(run["dir"] / f"prefix_band{r}.npz") as f:
            parts.append(f["part"])
    np.testing.assert_array_equal(
        (torch.tensor(parts[0]) + torch.tensor(parts[1])).numpy(),
        band["total"])
    assert np.abs(band["part"]).max() > 0


@pytest.mark.parametrize("name,single", [("b2", "single_p"),
                                         ("b4", "single_p"),
                                         ("sp", "single_q")])
def test_sharded_render_matches_single(run, name, single):
    """The same against the port's single-process ``render``; the bands'
    instance counts add up to no overflow."""
    r = run["ranks"][0]
    close_render(r, r, f"{name}_", f"{single}_")
    assert int(r[f"{name}_overflow"]) == 0
    bands = r[f"{name}_band_num_instances"]
    assert bands.shape == ((2,) if name == "b2" else (4,))
    assert int(r[f"{name}_num_instances"]) == int(bands.sum()) > 0


def test_render_sharded_and_train_step(run):
    """``render_sharded`` (padded output) and 3 ``sharded_train_step`` SGD
    steps on 4 bands against JAX's."""
    r, j = run["ranks"][0], run["jax"]
    for k in ("render", "render_dep", "final_T"):
        np.testing.assert_allclose(r[f"rs_{k}"], j["rs"][k], atol=PIX_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(r["sts_loss"], j["sts"]["loss"], rtol=1e-5)
    assert r["sts_loss"][2] < r["sts_loss"][0]
    for k in wk.PARAM_KEYS:
        np.testing.assert_allclose(r[f"sts_{k}"], j["sts"][k], atol=SGD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("ref", ["jax", "port"])
def test_mapping_chunk_with_mesh(run, ref):
    """3 mapping iterations (loss, grads, Adam, densify statistics) on 4
    bands against JAX ``mapping_chunk(mesh=)`` and the port's single
    process: parameters 1e-3, logit_opacity 1e-2, grad_denom exact."""
    r = run["ranks"][0]
    want = run["jax"]["map"] if ref == "jax" else {
        k: r[f"single_map_{k}"] for k in wk.FIELD_OUT}
    assert float(r["map_loss"]) > 1e-3
    assert np.abs(r["map_means"] - run["inp"]["mf_means"]).sum() > 0
    for k in ("means", "quats", "log_scales", "sh_dc", "max_radii2d"):
        np.testing.assert_allclose(r[f"map_{k}"], want[k], atol=PARAM_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(r["map_logit_opacity"], want["logit_opacity"],
                               atol=OPACITY_TOL)
    close_grads(r["map_grad_accum"], want["grad_accum"], "grad_accum")
    np.testing.assert_array_equal(r["map_grad_denom"], want["grad_denom"])


def test_mapping_chunk_prefix_with_mesh(run):
    """``mapping_chunk(mesh=)`` with ``grad_sum="prefix"`` on 4 bands
    against JAX's chunk on the same mesh, at the gates above."""
    r, want = run["ranks"][0], run["jax"]["map"]
    assert float(r["pmap_loss"]) > 1e-3
    for k in ("means", "quats", "log_scales", "sh_dc", "max_radii2d"):
        np.testing.assert_allclose(r[f"pmap_{k}"], want[k], atol=PARAM_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(r["pmap_logit_opacity"],
                               want["logit_opacity"], atol=OPACITY_TOL)
    close_grads(r["pmap_grad_accum"], want["grad_accum"], "grad_accum")
    np.testing.assert_array_equal(r["pmap_grad_denom"], want["grad_denom"])


@pytest.mark.parametrize("ref", ["jax", "port"])
def test_tracking_loop_with_mesh(run, ref):
    """GN (2 iterations) then 4 Adam steps on the pose, rendering on 2
    bands, against JAX ``tracking_loop(mesh=)`` and the port's single
    process."""
    r = run["ranks"][0]
    want = run["jax"]["trk"] if ref == "jax" else {
        "q": r["single_trk_q"], "t": r["single_trk_t"]}
    np.testing.assert_allclose(r["trk_q"], want["q"], atol=POSE_TOL)
    np.testing.assert_allclose(r["trk_t"], want["t"], atol=POSE_TOL)
    assert np.abs(r["trk_t"] - run["inp"]["m_t0"]).sum() > 0


@pytest.mark.parametrize("rank", range(4))
def test_multiseq_equals_individual(run, rank):
    """Each data rank's sequence after ``multiseq_mapping_chunk`` (4
    iterations, local Pearson and densify on) bitwise the port's single
    ``mapping_chunk`` on that sequence; aux gathered over the data axis."""
    r = run["ranks"][rank]
    for k in wk.FIELD_OUT:
        np.testing.assert_array_equal(r[f"ms_{k}"], r[f"single_ms_{k}"],
                                      err_msg=k)
    assert r["ms_loss"].shape == (4,)
    np.testing.assert_array_equal(
        r["ms_loss"], [float(q["single_ms_loss"]) for q in run["ranks"]])
    np.testing.assert_array_equal(r["ms_iteration"], [4] * 4)


def test_ranks_bitwise_equal(run):
    """Every result but the per-sequence ones is the same bits on all 4
    ranks (checked by the ranks' own all-gather too)."""
    ranks = run["ranks"]
    assert all(bool(r["ranks_equal"]) for r in ranks)
    for k, v in ranks[0].items():
        if k.startswith(("ms_", "single_", "tr_panels")):
            continue
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_trainer_with_mesh(run):
    """A Trainer on the 2 x 2 mesh: the Trainer gate against one without
    a mesh; only rank 0 wrote panels, metrics.jsonl rows and checkpoints
    (each once) into the directory the ranks share."""
    r0, want = run["ranks"][0], run["ranks"][1]
    for k in wk.FIELD_OUT + ("quats_pose", "trans"):
        close_params(r0[f"tr_{k}"], want[f"single_tr_{k}"], k, atol=1e-3)
    assert int(r0["tr_panels"]) == 2
    assert all(int(r["tr_panels"]) == 0 for r in run["ranks"][1:])
    d = run["dir"] / "trainer"
    rows = (d / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == int(r0["tr_history"])
    assert sorted(p.name for p in d.iterdir() if p.is_dir()) == [
        "ckpt_0000002", "ckpt_0000004", "ckpt_final"]


def test_dryrun(run):
    """The torchrun dry run's checks on the 2 x 2 mesh (loss above 1e-3,
    field and pose moved, the multi-sequence chunk, ranks equal)."""
    res = json.loads(str(run["ranks"][0]["dryrun"]))
    assert res["loss"] > 1e-3 and res["field_moved"] > 0
    assert res["pose_moved"] > 0
    assert res["mesh"] == {"data": 2, "tiles": 2}
    assert len(res["multiseq_loss"]) == 2
