"""The in-memory input sequence against the recipe written in the SCARED
layout and loaded back (``make_scene`` -> ``save_synthetic_as_scared`` ->
``load_scared``) at a small size."""

import numpy as np
import pytest
import torch

from freesurgs_tpu_torch.data.scared import load_scared, \
    save_synthetic_as_scared
from freesurgs_tpu_torch.data.synthetic import make_scene
from perfbench import scene

H, W, FRAMES, KEEP = 48, 64, 14, 12


def _spec(prior):
    return {"image": {"height": H, "width": W},
            "scene": {"gaussians": 300, "frames_generated": FRAMES,
                      "scale_range": [0.02, 0.06]},
            "data": {"frames": KEEP, "sample_rate": 8, "depth_prior": prior}}


@pytest.mark.parametrize("prior", ["metric", "normalized"])
def test_sequence_matches_round_trip(tmp_path, prior):
    seed = 2 ** 31 + 11
    sc = make_scene(num_frames=FRAMES, n_gaussians=300, height=H, width=W,
                    seed=seed, scale_range=(0.02, 0.06), device="cpu")
    save_synthetic_as_scared(sc, str(tmp_path))
    want = load_scared(str(tmp_path), 0, KEEP, sample_rate=8, cache=None,
                       depth_prior=prior)
    got = scene.make_sequence(seed, _spec(prior), "cpu")
    assert got.colors.shape == (KEEP, 3, H, W)
    diff = np.abs(got.colors.numpy() - want.colors)
    # a colour on an 8-bit step may round the other way: at most one step,
    # on a tiny share of the values
    assert diff.max() <= 1 / 255 + 1e-7
    assert (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(got.monodeps.numpy(), want.monodeps,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.flows_fw.numpy(), want.flows_fw,
                               atol=1e-3)
    np.testing.assert_allclose(got.gt_w2c, want.gt_poses["k0"], atol=1e-6)
    np.testing.assert_array_equal(got.K.astype(np.float64),
                                  want.cam.intrinsic_matrix())
    assert (got.cam.fx, got.cam.cy) == (want.cam.fx, want.cam.cy)
    np.testing.assert_array_equal(got.i_train, want.i_train)
    np.testing.assert_array_equal(got.i_test, want.i_test)


def test_sequence_is_a_function_of_the_seed():
    a = scene.make_sequence(5, _spec("metric"), "cpu")
    b = scene.make_sequence(5, _spec("metric"), "cpu")
    c = scene.make_sequence(6, _spec("metric"), "cpu")
    assert torch.equal(a.colors, b.colors)
    assert not torch.equal(a.colors, c.colors)
