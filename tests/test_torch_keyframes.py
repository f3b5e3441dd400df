"""Overlap keyframe selection (``train/keyframes.py`` and the overlap
branch of ``mapping_chunk``) against the JAX package, in the cases that do
not depend on the random draws (the port draws from a ``torch.Generator``,
JAX from split keys), so every comparison is exact or within f32
rounding:

- the overlap scores with ``pixels`` equal to the number of valid pixels
  (the draw then takes every valid pixel: the score is a mean over all of
  them), with all depths valid, with part of the map invalid, and with
  more pixels asked for than are valid (the draw then also takes invalid
  pixels, which back-project to the camera centre): 1e-6;
- the selection with one positive score, with none (JAX's reversed stable
  argsort picks the last position) and with fewer positives than k;
- a two-view mapping chunk with one keyframe, against JAX's oracle path:
  tests/test_torch_train.py's chunk gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.core.transforms import build_w2c as jbuild_w2c
from freesurgs_tpu.train import keyframes as jk
from freesurgs_tpu.train import steps as js
from freesurgs_tpu.train.optim import adam_init as jadam_init
from freesurgs_tpu_torch.train import keyframes as tk
from freesurgs_tpu_torch.train import steps as ts
from freesurgs_tpu_torch.train.optim import adam_init as tadam_init

from test_torch_train import PARAMS, close_params, scene, tcam  # noqa: F401

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

# large enough that the 20 px edge leaves most of the image
CAM = JCam(height=96, width=128, fx=120.0, fy=120.0, cx=64.0, cy=48.0)


def _poses():
    """Keyframe w2c's from near the current view to one facing away."""
    q = np.asarray([[1, 0, 0, 0], [0.999, 0.03, -0.02, 0.01],
                    [0.98, 0.0, 0.2, 0.0], [0.0, 0.0, 1.0, 0.0]], np.float32)
    t = np.asarray([[0, 0, 0], [0.05, -0.02, 0.1], [0.3, 0.1, -0.2],
                    [0, 0, 0]], np.float32)
    return np.asarray(jbuild_w2c(jnp.asarray(q), jnp.asarray(t)))


@pytest.mark.parametrize("valid", ["all", "part", "fewer"])
def test_overlap_scores_match_jax(valid):
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 3.0, (96, 128)).astype(np.float32)
    if valid != "all":
        depth[rng.uniform(size=depth.shape) < 0.4] = 0.0
    n_valid = int((depth > 0).sum())
    pixels = n_valid if valid != "fewer" else n_valid + 200
    cur = np.asarray(jbuild_w2c(jnp.asarray([0.995, 0.0, 0.1, 0.0]),
                                jnp.asarray([0.02, 0.0, 0.05])))
    kfs = _poses()
    js_ = jk.keyframe_overlap_scores(jnp.asarray(depth), jnp.asarray(cur),
                                     jnp.asarray(kfs), CAM,
                                     jax.random.PRNGKey(0), pixels=pixels)
    ts_ = tk.keyframe_overlap_scores(
        torch.tensor(depth), torch.tensor(cur), torch.tensor(kfs), tcam(CAM),
        torch.Generator().manual_seed(0), pixels=pixels)
    js_ = np.asarray(js_)
    assert js_.min() < 0.05 < 0.3 < js_.max()          # the scores vary
    np.testing.assert_allclose(js_, ts_.numpy(), atol=1e-6)


@pytest.mark.parametrize("scores,k", [([0.0, 0.4, 0.0, 0.0], 1),
                                      ([0.0, 0.4, 0.0, 0.0], 3),
                                      ([0.0, 0.0, 0.0, 0.0], 2),
                                      ([0.0, 0.3, 0.0, 0.7], 3)])
def test_select_overlap_keyframes(scores, k):
    """One positive: always it; none: the last position (JAX); fewer
    positives than k: each positive once, then the last one repeats."""
    sel_j = np.asarray(jk.select_overlap_keyframes(
        jnp.asarray(scores), jax.random.PRNGKey(1), k))
    sel_t = tk.select_overlap_keyframes(
        torch.tensor(scores), torch.Generator().manual_seed(1), k).numpy()
    pos = [i for i, s in enumerate(scores) if s > 0]
    for sel in (sel_j, sel_t):
        if len(pos) <= 1:
            np.testing.assert_array_equal(sel, [pos[0] if pos else 3] * k)
        else:
            assert sorted(sel[:2].tolist()) == pos and sel[2] == sel[1]
    if len(pos) <= 1:
        np.testing.assert_array_equal(sel_j, sel_t)


def test_mapping_chunk_overlap_one_keyframe(scene):
    """Two views, keyframe_policy="overlap", keyframes [0]: whether frame 0
    overlaps or not, the pick is frame 0 in both packages (JAX's padded
    keyframe array holds 0 at its last position)."""
    sc, jf, tf = scene
    n_it = 3
    cfg_kw = dict(w_local_pearson=0.0, keyframe_policy="overlap",
                  densify_interval=1000, opacity_reset_interval=1000)
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
        jnp.int32(1), sc.cam, js.TrainConfig(impl="oracle", **cfg_kw), True,
        1)
    tstate = ts.MappingState(
        field=tf, opt=tadam_init(tf.param_dict()), iteration=0,
        generator=torch.Generator().manual_seed(0),
        pred_depths=torch.zeros(2, 64, 80, dtype=torch.bfloat16),
        pred_colors=torch.zeros(2, 3, 64, 80, dtype=torch.bfloat16))
    tst, taux = ts.mapping_chunk(
        tstate, torch.tensor(colors), torch.tensor(monodeps),
        torch.tensor(w2c), [1] * n_it, [0], tcam(sc.cam),
        ts.TrainConfig(**cfg_kw), True, 1)
    assert taux["keyframe_views"].tolist() == [0] * n_it
    assert float(taux["overflow_max"]) == 0
    np.testing.assert_allclose(float(jaux["loss"]), float(taux["loss"]),
                               rtol=1e-4)
    for k in PARAMS:
        close_params(getattr(jst.field, k), getattr(tst.field, k), k)
    for k in ("grad_accum", "grad_denom", "max_radii2d"):
        np.testing.assert_allclose(np.asarray(getattr(jst.field, k)),
                                   getattr(tst.field, k).numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_unknown_keyframe_policy_raises():
    with pytest.raises(ValueError, match="keyframe_policy"):
        ts.check_supported(ts.TrainConfig(keyframe_policy="nearest"))
