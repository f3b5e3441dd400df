"""The port's SCARED loader and fixture writer (``data/scared.py``) against
the JAX package's: the same directory gives bitwise the same colors, flows
and priors, and exactly the same splits, boundaries, names and poses, under
both depth priors, raw and through the FSC1 cache each package writes for
the other. The scene is numpy arrays from a seed (no renderer needed).
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from freesurgs_tpu.data import scared as jsc
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.data import scared as tsc
from freesurgs_tpu_torch.io.png import read_png

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)


def _scene(t=5, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(t, 3, 3))
    w2c = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
    for i in range(t):
        w2c[i, :3, :3] = np.linalg.qr(q[i])[0]
        w2c[i, :3, 3] = rng.normal(size=3) * 0.1
    return SimpleNamespace(
        cam=TCam(height=h, width=w, fx=w * 1.1, fy=w * 1.1, cx=w / 2,
                 cy=h / 2),
        colors=rng.uniform(size=(t, 3, h, w)).astype(np.float32),
        depths=rng.uniform(0.8, 2.5, (t, h, w)).astype(np.float32),
        gt_w2c=w2c,
        flows_fw=rng.normal(size=(t - 1, 2, h, w)).astype(np.float32))


def _same(a, b, exact_poses=True):
    for k in ("colors", "flows_fw", "flows_bw", "monodeps"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype == np.float32, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    for k in ("i_train", "i_test"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert list(a.boundaries) == list(b.boundaries)
    assert list(a.image_names) == list(b.image_names)
    assert list(a.gt_poses) == list(b.gt_poses)
    for k in a.gt_poses:
        if exact_poses:
            np.testing.assert_array_equal(a.gt_poses[k], b.gt_poses[k])
        else:          # the cache stores f32
            np.testing.assert_allclose(a.gt_poses[k], b.gt_poses[k],
                                       rtol=1e-6, atol=1e-7)
    ka, kb = a.cam.intrinsic_matrix(), b.cam.intrinsic_matrix()
    if exact_poses:
        np.testing.assert_array_equal(ka, kb)
    else:
        np.testing.assert_allclose(ka, kb, rtol=1e-6)
    assert (a.cam.height, a.cam.width) == (b.cam.height, b.cam.width)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """One scene written by each package's writer."""
    sc = _scene()
    j, t = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jsc.save_synthetic_as_scared(sc, str(j))
    tsc.save_synthetic_as_scared(sc, str(t))
    return sc, str(j), str(t)


def test_fixture_writer_matches_jax(dirs):
    """The port's writer writes the JAX writer's files: the same names,
    decoded frames, npz arrays and json."""
    sc, j, t = dirs
    names = sorted(os.path.relpath(os.path.join(r, f), j)
                   for r, _, fs in os.walk(j) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), t)
                           for r, _, fs in os.walk(t) for f in fs)
    for n in names:
        a, b = os.path.join(j, n), os.path.join(t, n)
        if n.endswith(".png"):
            np.testing.assert_array_equal(read_png(a), read_png(b))
        elif n.endswith(".npz"):
            np.testing.assert_array_equal(np.load(a)["pred"],
                                          np.load(b)["pred"])
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb)
    np.testing.assert_array_equal(
        read_png(os.path.join(t, "input", "d1_k0_frame_000002.png")),
        tsc.frame_uint8(sc.colors[2]))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("prior", ["normalized", "metric"])
def test_load_matches_jax(dirs, writer, prior):
    """Either package's fixture: both loaders, uncached, agree bitwise."""
    _, j, t = dirs
    root = j if writer == "jax" else t
    a = jsc.load_scared(root, sample_rate=4, cache=None, depth_prior=prior)
    b = tsc.load_scared(root, sample_rate=4, cache=None, depth_prior=prior)
    _same(a, b)
    assert list(b.i_test) == [2] and list(b.i_train) == [0, 1, 3, 4]
    assert b.cam == TCam.from_K(a.cam.intrinsic_matrix(), 24, 32)


def test_load_frame_range_and_subsequences(tmp_path):
    """Two <data> subsequences (boundaries, per-key poses) and a
    frame_start / frame_end cut, as the JAX loader splits them."""
    sc = _scene(t=5, seed=1)
    first = SimpleNamespace(**{**vars(sc), "colors": sc.colors[:3],
                               "depths": sc.depths[:3],
                               "gt_w2c": sc.gt_w2c[:3],
                               "flows_fw": sc.flows_fw[:2]})
    second = SimpleNamespace(**{**vars(sc), "colors": sc.colors[3:],
                                "depths": sc.depths[3:],
                                "gt_w2c": sc.gt_w2c[3:],
                                "flows_fw": sc.flows_fw[3:]})
    tsc.save_synthetic_as_scared(first, str(tmp_path), data_ind="k0")
    tsc.save_synthetic_as_scared(second, str(tmp_path), data_ind="k1")
    flow = tmp_path / "flow"          # the cross-boundary flow pair
    for d in ("fw", "bw"):
        np.savez(flow / f"flow_{d}_d1_k0_frame_000002.npz",
                 pred=sc.flows_fw[2])
    for kw in ({}, {"frame_start": 1, "frame_end": 4}):
        a = jsc.load_scared(str(tmp_path), sample_rate=2, cache=None, **kw)
        b = tsc.load_scared(str(tmp_path), sample_rate=2, cache=None, **kw)
        _same(a, b)
    assert b.boundaries == [0, 2, 3] and list(b.gt_poses) == ["k0", "k1"]


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("prior", ["normalized", "metric"])
def test_cache_auto_shared_with_jax(tmp_path, dirs, first, prior):
    """cache="auto": the first package's load writes the cache, the other
    package's load reads that file (no raw decode), and both equal the
    uncached load (poses and intrinsics to f32 rounding)."""
    _, j, _ = dirs
    root = str(tmp_path / "d")
    shutil.copytree(j, root)
    mods = (jsc, tsc) if first == "jax" else (tsc, jsc)
    raw = tsc.load_scared(root, sample_rate=4, cache=None, depth_prior=prior)
    mods[0].load_scared(root, sample_rate=4, depth_prior=prior)
    cpath = tsc.cache_path(root, 0, -1, 4, prior)
    assert os.listdir(root).count(os.path.basename(cpath)) == 1
    shutil.rmtree(os.path.join(root, "input"))   # only the cache is left
    cached = mods[1].load_scared(root, sample_rate=4, depth_prior=prior)
    _same(raw, cached, exact_poses=False)


def test_corrupt_cache_is_rebuilt(tmp_path, dirs):
    _, j, _ = dirs
    root = str(tmp_path / "d")
    shutil.copytree(j, root)
    cpath = tsc.cache_path(root, 0, -1, 8, "normalized")
    with open(cpath, "wb") as f:
        f.write(b"not a cache")
    seq = tsc.load_scared(root)
    _same(seq, tsc.load_scared(root, cache=None))
    again = tsc.load_scared(root)                  # the rebuilt cache
    _same(again, seq, exact_poses=False)


def test_jpeg_frames_raise(tmp_path, dirs):
    _, j, _ = dirs
    root = str(tmp_path / "d")
    shutil.copytree(j, root)
    jpg = os.path.join(root, "input", "d1_k0_frame_000009.jpg")
    open(jpg, "wb").close()
    with pytest.raises(NotImplementedError, match="frame_000009.jpg"):
        tsc.load_scared(root, cache=None)
