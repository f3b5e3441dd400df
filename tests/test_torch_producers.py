"""The raw-frames path of the port against the JAX package: the warps
(``core/warp.py``), Horn-Schunck flow and the parallax disparity
(``data/flow_hs.py``), ``make_nonrigid_scene`` (``data/synthetic.py``) and
the producer command (``cli/produce_inputs.py``), run in-process, then
loaded by ``load_scared``.

Inputs are the same numpy arrays for both packages: random arrays from a
seed, or frames and flows of the port's ``make_scene`` on the CPU.

Tolerances: the warps are a few f32 products and sums of the same taps,
1e-5 absolute. ``hs_flow`` runs 4 levels x 3 warps x 60 Jacobi sweeps in
the same per-element order in both (XLA may fuse and contract differently):
held to 1e-3 px; the measured worst is ~2e-6 px at 64x96.
``parallax_disparity`` to 1e-5 relative. ``make_nonrigid_scene`` at the
``make_scene`` gates of tests/test_torch_render.py (frames and memberships
2e-5, depths 1e-4, flows 1e-3 px); the non-rigid mask is the memberships
thresholded at 0.3, so it may differ only where the memberships lie within
that tolerance of the threshold.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core import warp as jwarp
from freesurgs_tpu.data import flow_hs as jhs
from freesurgs_tpu.data.synthetic import make_nonrigid_scene as jnonrigid
from freesurgs_tpu_torch.cli import produce_inputs as prod
from freesurgs_tpu_torch.core import warp as twarp
from freesurgs_tpu_torch.data import flow_hs as ths
from freesurgs_tpu_torch.data.scared import (load_scared,
                                             save_synthetic_as_scared)
from freesurgs_tpu_torch.data.synthetic import make_nonrigid_scene, \
    make_scene
from freesurgs_tpu_torch.io.png import read_png

WARP_TOL = 1e-5
HS_TOL = 1e-3
DISP_RTOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    """The JAX producer test's scene (64x96, 400 Gaussians, seed 11),
    rendered by the port on the CPU."""
    return make_scene(num_frames=3, n_gaussians=400, height=64, width=96,
                      seed=11, device="cpu")


def test_bilinear_and_flow_warp():
    """Zero padding at each tap: coordinates inside, on and beyond every
    border."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(3, 24, 32)).astype(np.float32)
    x = rng.uniform(-3, 35, (40, 50)).astype(np.float32)
    y = rng.uniform(-3, 27, (40, 50)).astype(np.float32)
    x[0, :4] = [0.0, 31.0, 31.5, -0.5]
    np.testing.assert_allclose(
        np.asarray(jax.jit(jwarp.bilinear_sample)(img, x, y)),
        twarp.bilinear_sample(*map(torch.tensor, (img, x, y))).numpy(),
        atol=WARP_TOL)
    flow = rng.normal(scale=4.0, size=(2, 24, 32)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax.jit(jwarp.flow_warp)(img, flow)),
        twarp.flow_warp(torch.tensor(img), torch.tensor(flow)).numpy(),
        atol=WARP_TOL)


def test_forward_backward_occlusion():
    rng = np.random.default_rng(1)
    fw = rng.normal(scale=3.0, size=(2, 24, 32)).astype(np.float32)
    bw = (-fw + rng.normal(scale=0.6, size=fw.shape)).astype(np.float32)
    j = np.asarray(jax.jit(jwarp.forward_backward_occlusion)(fw, bw))
    t = twarp.forward_backward_occlusion(torch.tensor(fw),
                                         torch.tensor(bw)).numpy()
    assert 0 < j.sum() < j.size
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("case", ["plain", "opacity_mask", "even", "none"])
def test_median_depth(case):
    """Index n // 2 - 1 of the sorted valid depths, as JAX reads it: an odd
    and an even count, opacity and mask filters, and n = 0 (+inf)."""
    rng = np.random.default_rng(2)
    depth = rng.uniform(-0.5, 3.0, (12, 16)).astype(np.float32)
    opac = rng.uniform(0, 1, (12, 16)).astype(np.float32)
    mask = rng.uniform(0, 1, (12, 16)) > 0.3
    kw_j, kw_t = {}, {}
    if case in ("plain", "even"):
        # an odd count for "plain", an even one for "even"
        if int((depth > 0).sum()) % 2 == (case == "plain"):
            depth.flat[np.flatnonzero(depth > 0)[0]] = -1.0
    elif case == "opacity_mask":
        kw_j = dict(opacity=jnp.asarray(opac), mask=jnp.asarray(mask))
        kw_t = dict(opacity=torch.tensor(opac), mask=torch.tensor(mask))
    else:
        depth = -np.abs(depth)
    j = float(jax.jit(jwarp.median_depth)(jnp.asarray(depth), **kw_j))
    t = float(twarp.median_depth(torch.tensor(depth), **kw_t))
    assert j == t
    assert (j == float("inf")) == (case == "none")


def test_hs_flow_matches_jax(scene):
    """Frames 0 -> 1 at 64x96 with 4 levels: the port against the JAX
    function (max |difference| within HS_TOL px), the JAX test's accuracy
    gate against the analytic flow on textured pixels, and a batched call
    (forward and backward pairs in one pass) bitwise the single calls."""
    a, b = scene.colors[0].numpy(), scene.colors[1].numpy()
    j = np.asarray(jhs.hs_flow(jnp.asarray(a), jnp.asarray(b), levels=4))
    t = ths.hs_flow(torch.tensor(a), torch.tensor(b), levels=4)
    assert float(np.abs(j - t.numpy()).max()) <= HS_TOL
    gt = scene.flows_fw[0].numpy()
    gx, gy = np.gradient(a.mean(0))
    textured = np.hypot(gx, gy) > 0.01
    epe = np.hypot(*(t.numpy() - gt))
    med = float(np.median(epe[textured]))
    gt_mag = float(np.median(np.hypot(*gt)[textured]))
    assert med < max(0.5, 0.5 * gt_mag), (med, gt_mag)
    both = ths.hs_flow(torch.tensor(np.stack([a, b])),
                       torch.tensor(np.stack([b, a])), levels=4)
    assert torch.equal(both[0], t)
    assert torch.equal(both[1], ths.hs_flow(torch.tensor(b), torch.tensor(a),
                                            levels=4))


def test_parallax_disparity_matches_jax(scene, monkeypatch):
    """An even count of flow values (64 x 96), where jnp.median averages
    the two middle values: the port matches to DISP_RTOL, and the same
    function with torch.median's lower middle value would not."""
    fw = scene.flows_fw[0].numpy()
    bw = (-fw + np.random.default_rng(3).normal(
        scale=0.3, size=fw.shape)).astype(np.float32)
    assert fw[0].size % 2 == 0
    j = np.asarray(jhs.parallax_disparity(jnp.asarray(fw), jnp.asarray(bw)))
    t = ths.parallax_disparity(torch.tensor(fw), torch.tensor(bw)).numpy()
    assert (t > 0).all()
    np.testing.assert_allclose(t, j, rtol=DISP_RTOL)
    monkeypatch.setattr(ths, "_median_midpoint",
                        lambda x: torch.median(x, dim=-1).values)
    lower = ths.parallax_disparity(torch.tensor(fw), torch.tensor(bw))
    assert float(np.max(np.abs(lower.numpy() - j) / j)) > DISP_RTOL


def test_make_nonrigid_scene_matches_jax():
    """48x64, 500 Gaussians, 3 frames: the same draws, the frames, depths,
    memberships and membership-displaced analytic flows of each package."""
    kw = dict(num_frames=3, n_gaussians=500, height=48, width=64, seed=5)
    js, ja = jnonrigid(impl="oracle", **kw)
    ts, ta = make_nonrigid_scene(device="cpu", **kw)
    for k, tol in (("gt_w2c", 1e-6), ("means", 0), ("sh", 1e-7),
                   ("log_scales", 0), ("logit_opacity", 0), ("quats", 0),
                   ("colors", 2e-5), ("depths", 1e-4), ("monodeps", 1e-4),
                   ("flows_fw", 1e-3)):
        np.testing.assert_allclose(np.asarray(getattr(js, k)),
                                   getattr(ts, k).numpy(), atol=tol,
                                   err_msg=k)
    for k in ("member_patch", "member_spec"):
        np.testing.assert_allclose(np.asarray(ja[k]), ta[k].numpy(),
                                   atol=2e-5, err_msg=k)
    jm, tm = np.asarray(ja["nonrigid_mask"]), ta["nonrigid_mask"].numpy()
    memb = np.asarray(ja["member_patch"]) + np.asarray(ja["member_spec"])
    assert jm.any() and (~jm).any()
    assert np.all((jm == tm) | (np.abs(memb - 0.3) <= 4e-5))


def test_produce_inputs_then_load(scene, tmp_path, capsys):
    """A frames-only directory -> ``produce`` in-process on the CPU ->
    ``load_scared``: the flow files are ``hs_flow`` of the decoded frames,
    each disparity the parallax proxy of its frame's flow pair (the end
    frames reuse their single neighbouring pair), float32 under ``pred``;
    files that exist are loaded, not recomputed, unless --overwrite;
    without a CUDA device the default device fails; a JPEG frame raises,
    naming it."""
    root = str(tmp_path / "seq")
    save_synthetic_as_scared(scene, root)
    for sub in ("flow", "monodep"):
        for f in os.listdir(os.path.join(root, sub)):
            os.remove(os.path.join(root, sub, f))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prod.main(["--root", root])
    res = prod.produce(root, levels=4, device="cpu", log=lambda s: None)
    assert (res["flow_pairs"], res["depth_maps"]) == (2, 3)

    names = sorted(os.listdir(os.path.join(root, "input")))
    stems = [n.split(".")[0] for n in names]
    frames = [torch.tensor(read_png(os.path.join(root, "input", n))
                           .astype(np.float32).transpose(2, 0, 1) / 255.0)
              for n in names]

    def npz(kind, stem):
        sub = "monodep" if kind == "depth" else "flow"
        with np.load(os.path.join(root, sub, f"{kind}_{stem}.npz")) as z:
            assert list(z.keys()) == ["pred"]
            return z["pred"]

    fw = [npz("flow_fw", s) for s in stems[:2]]
    bw = [npz("flow_bw", s) for s in stems[:2]]
    for t in range(2):
        assert fw[t].dtype == np.float32
        np.testing.assert_array_equal(
            fw[t], ths.hs_flow(frames[t], frames[t + 1], levels=4).numpy())
        np.testing.assert_array_equal(
            bw[t], ths.hs_flow(frames[t + 1], frames[t], levels=4).numpy())
    for t, (f, b) in enumerate([(fw[0], bw[0]), (fw[1], bw[0]),
                                (fw[1], bw[1])]):
        d = npz("depth", stems[t])
        assert d.dtype == np.float32 and d.shape == (64, 96)
        np.testing.assert_array_equal(d, ths.parallax_disparity(
            torch.tensor(f), torch.tensor(b)).numpy())

    before = {p: os.path.getmtime(os.path.join(root, sub, p))
              for sub in ("flow", "monodep")
              for p in os.listdir(os.path.join(root, sub))}
    capsys.readouterr()
    assert prod.main(["--root", root, "--levels", "4", "--device",
                      "cpu"]) == 0
    assert "wrote 0 flow pairs + 0 disparity maps" in capsys.readouterr().out
    assert before == {p: os.path.getmtime(os.path.join(root, sub, p))
                      for sub in ("flow", "monodep")
                      for p in os.listdir(os.path.join(root, sub))}
    again = prod.produce(root, levels=4, device="cpu", overwrite=True,
                         log=lambda s: None)
    assert (again["flow_pairs"], again["depth_maps"]) == (2, 3)

    seq = load_scared(root, cache=None)
    t, _, h, w = seq.colors.shape
    assert seq.flows_fw.shape == (t - 1, 2, h, w)
    assert seq.flows_bw.shape == (t - 1, 2, h, w)
    np.testing.assert_array_equal(seq.flows_fw[1], fw[1])
    assert seq.monodeps.shape == (t, h, w)
    assert seq.monodeps.min() >= 0.5 - 1e-5
    assert seq.monodeps.max() <= 1.5 + 1e-5

    jpg = os.path.join(root, "input", "d1_k0_frame_000009.jpg")
    open(jpg, "wb").close()
    with pytest.raises(NotImplementedError, match="frame_000009.jpg"):
        prod.produce(root, device="cpu", log=lambda s: None)
