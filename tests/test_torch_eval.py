"""The port's evaluation (``eval/``) against the JAX package's: pose metrics
(Umeyama sim(3), ATE, RPE, the weighted subsequence average), PSNR, the
scipy SSIM and the AlexNet LPIPS with its random-feature trunk and with
exported weights.

Tolerances: the pose metrics and SSIM are the same numpy / scipy code in
float64 (1e-12 relative); PSNR the same numpy f32 code (exact). LPIPS runs
the same convolutions in torch and XLA, summed in another order: 1e-4
relative on distances of ~1e-2.
"""

import numpy as np
import pytest
import torch

from freesurgs_tpu.eval import image_metrics as jim
from freesurgs_tpu.eval import lpips_jax as jlp
from freesurgs_tpu.eval import pose_metrics as jpm
from freesurgs_tpu_torch.eval import image_metrics as tim
from freesurgs_tpu_torch.eval import lpips as tlp
from freesurgs_tpu_torch.eval import pose_metrics as tpm

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)


def trajectory(rng, n, noise):
    """(n, 4, 4) w2c poses along a wobbly path, and a noisy, rescaled,
    rotated copy of it (what a tracker returns)."""
    out = []
    for i in range(n):
        a = 0.05 * i + rng.normal(0, noise)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [0.1 * i, 0.02 * i * i, 0.05 * np.sin(i)]
        T[:3, 3] += rng.normal(0, noise, 3)
        out.append(T)
    return np.stack(out)


def test_pose_metrics():
    rng = np.random.default_rng(0)
    gt = trajectory(rng, 12, 0.0)
    est = trajectory(rng, 12, 0.01)
    est[:, :3, 3] *= 2.5                      # monocular scale
    s1 = jpm.umeyama_sim3(est[:, :3, 3], gt[:, :3, 3])
    s2 = tpm.umeyama_sim3(est[:, :3, 3], gt[:, :3, 3])
    np.testing.assert_allclose(s1[0], s2[0], rtol=1e-12)
    np.testing.assert_allclose(s1[1], s2[1], rtol=1e-12, atol=1e-15)
    gt_by_seq = {"a": gt[:5], "b": gt[5:]}
    j = jpm.evaluate_subsequences(est, gt_by_seq, [0, 5, 12])
    t = tpm.evaluate_subsequences(est, gt_by_seq, [0, 5, 12])
    for k in ("ate", "rpe_trans", "rpe_rot_deg"):
        np.testing.assert_allclose(j[k], t[k], rtol=1e-12, err_msg=k)
        assert np.isfinite(t[k]) and t[k] > 0
    assert t["per_seq"].keys() == j["per_seq"].keys()
    bad = est.copy()
    bad[3, 0, 0] = np.nan
    assert tpm.evaluate_poses(bad, gt)["non_finite_poses"] == 1


def images(seed, t=2, h=72, w=88):
    rng = np.random.default_rng(seed)
    gts = rng.uniform(0, 1, (t, 3, h, w)).astype(np.float32)
    preds = np.clip(gts + rng.normal(0, 0.08, gts.shape), 0, 1
                    ).astype(np.float32)
    return gts, preds


def test_psnr_and_ssim():
    gts, preds = images(1)
    assert jim.psnr(gts, preds) == tim.psnr(gts, preds)
    np.testing.assert_allclose(jim.ssim_metric(gts, preds),
                               tim.ssim_metric(gts, preds), rtol=1e-12)
    assert tim.ssim_metric(gts, gts) == pytest.approx(1.0)


def test_random_feature_lpips():
    """The same fixed-seed trunk in both packages, and the same distance."""
    jw, tw = jlp.random_weights(), tlp.random_weights()
    assert jw.keys() == tw.keys()
    for k in jw:
        np.testing.assert_array_equal(np.asarray(jw[k]), tw[k], err_msg=k)
    gts, preds = images(2)
    j = jlp.lpips_alex(gts, preds, jw)
    t = tlp.lpips_alex(gts, preds, tw, device="cpu")
    np.testing.assert_allclose(j, t, rtol=1e-4)
    assert t > 0
    assert tlp.lpips_alex(gts, gts, tw, device="cpu") == pytest.approx(
        0.0, abs=1e-7)


@pytest.mark.parametrize("exported", [False, True])
def test_lpips_backend_and_rgb_evaluation(tmp_path, monkeypatch, exported):
    """Both packages resolve the weights the same way: an exported .npz
    named by the environment variable, else the random-feature trunk."""
    path = tmp_path / "lpips_alex_v01.npz"
    if exported:
        w = tlp.random_weights(seed=3)
        np.savez(path, **w)
    monkeypatch.setenv(tlp.WEIGHTS_ENV, str(path))
    gts, preds = images(4, t=1, h=64, w=64)
    j = jim.rgb_evaluation(gts, preds)
    t = tim.rgb_evaluation(gts, preds, device="cpu")
    want = "weights" if exported else "random_features"
    assert j["lpips_backend"] == t["lpips_backend"] == want
    assert j["psnr"] == t["psnr"]
    np.testing.assert_allclose(j["ssim"], t["ssim"], rtol=1e-12)
    np.testing.assert_allclose(j["lpips"], t["lpips"], rtol=1e-4)
