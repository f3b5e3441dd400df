"""``cli.eval_ckpt`` against ``scripts/eval_ckpt.py``, on the CPU.

A 6-frame 32x48 scene (``make_scene``, written as a SCARED directory;
frame 4 the test frame at ``sample_rate=8``) gets a state without
training: the JAX Trainer's initial field, its poses set to the ground
truth with a small offset on every frame but 0 (so that ATE / RPE are not
zero and the test pose has something to refine). Each package's own
Trainer saves it, the port's after taking the state over by ``convert.py``.
Then the JAX script's ``main`` and the port's run on their checkpoints with
``--refine_iters 2``: the printed keys are the JAX script's plus
``device``, and every number (PSNR, SSIM, random-feature LPIPS, the
train PSNR, ATE / RPE, the pose-refined test PSNR) agrees to one unit of
the 5th decimal both print, though the JAX script renders through
``pallas_interpret`` and the port through the plain compositing.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.data.scared import load_scared as jload_scared
from freesurgs_tpu.models.pose import PoseTable as JPoseTable
from freesurgs_tpu.train.loop import Trainer as JTrainer
from freesurgs_tpu.train.steps import TrainConfig as JTrainConfig
from freesurgs_tpu_torch import convert
from freesurgs_tpu_torch.cli import eval_ckpt
from freesurgs_tpu_torch.core.transforms import rotmat_to_quat
from freesurgs_tpu_torch.data.scared import (load_scared,
                                              save_synthetic_as_scared)
from freesurgs_tpu_torch.data.synthetic import make_scene
from freesurgs_tpu_torch.train.loop import Trainer
from freesurgs_tpu_torch.train.steps import TrainConfig

from test_torch_viz import one_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
FRAMES = 6
ARGS = ["--frames", str(FRAMES), "--refine_iters", "2"]
# Both scripts print their numbers rounded to 5 decimals; two values that
# round apart by one unit of that place pass (measured on the CPU:
# every number equal as printed).
PRINTED = 1e-5 * (1 + 1e-9)


def offset_gt_poses(seq) -> tuple[np.ndarray, np.ndarray]:
    """(quats, trans): each frame's ground-truth w2c relative to frame 0,
    translated by 2e-3 per frame index (frame 0 stays the identity)."""
    gt = np.concatenate([np.asarray(v) for v in seq.gt_poses.values()])
    rel = (gt @ np.linalg.inv(gt[0])).astype(np.float32)
    trans = rel[:, :3, 3] + 2e-3 * np.arange(FRAMES, dtype=np.float32
                                             )[:, None]
    return rotmat_to_quat(torch.from_numpy(rel[:, :3, :3])).numpy(), trans


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalckpt")
    data = root / "data"
    save_synthetic_as_scared(make_scene(
        num_frames=FRAMES, n_gaussians=400, height=32, width=48, seed=4,
        device="cpu"), str(data))
    jseq = jload_scared(str(data), 0, FRAMES, sample_rate=8, cache=None)
    assert list(jseq.i_test) == [4]
    jtr = JTrainer(jseq, JTrainConfig(max_instances=4096),
                   log_fn=lambda *a: None)
    quats, trans = offset_gt_poses(jseq)
    jtr.poses = JPoseTable(quats=jnp.asarray(quats),
                           trans=jnp.asarray(trans))
    jtr.active_sh_degree = 1
    jtr.save(str(root / "jax_ckpt"))

    ttr = Trainer(load_scared(str(data), 0, FRAMES, sample_rate=8,
                              cache=None), TrainConfig(), device="cpu",
                  log_fn=lambda *a: None)
    f = jtr.field
    field = convert.field_from_numpy(
        {k: np.asarray(getattr(f, k)) for k in convert.FIELD_KEYS},
        device="cpu", max_sh_degree=f.max_sh_degree)
    opt = jtr.state.opt
    ttr._resize_capacity(field.capacity)
    ttr.state.field = field
    ttr.state.opt = convert.adam_from_numpy(
        {k: np.asarray(v) for k, v in opt.mu.items()},
        {k: np.asarray(v) for k, v in opt.nu.items()}, int(opt.count),
        device="cpu")
    ttr.poses = convert.poses_from_numpy(quats, trans, device="cpu")
    ttr.active_sh_degree = 1
    ttr.save(str(root / "port_ckpt"))
    return data, root


def jax_eval(monkeypatch, capsys, ckpt, data) -> dict:
    """The JAX script's main on its checkpoint: its last printed line."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_ckpt", REPO / "scripts" / "eval_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setenv("FSTPU_COMPILE_CACHE", "")   # no cache on disk
    monkeypatch.setattr(sys, "argv", ["eval_ckpt.py", "--ckpt", str(ckpt),
                                      "--data", str(data), *ARGS])
    mod.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_ckpt_matches_jax_script(checkpoints, monkeypatch, capsys):
    data, root = checkpoints
    want = jax_eval(monkeypatch, capsys, root / "jax_ckpt", data)
    assert eval_ckpt.main(["--ckpt", str(root / "port_ckpt"), "--data",
                           str(data), *ARGS, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu" and got["refine_iters"] == 2
    assert got["lpips_backend"] == want["lpips_backend"]
    for k in ("psnr", "ssim", "lpips", "psnr_train", "ate", "rpe_trans",
              "rpe_rot_deg", "psnr_test_pose_refined"):
        assert abs(got[k] - want[k]) <= PRINTED, (k, got[k], want[k])
    # the refinement moved the test pose (it keeps the best pose seen)
    assert got["psnr_test_pose_refined"] >= got["psnr"] - 1e-6


def test_eval_ckpt_counts_its_renders(checkpoints):
    """The renders the command reports making: the validation's views
    (the test frame, every 8th train frame), then per test frame the
    refinement's steps and the render at the refined pose."""
    data, root = checkpoints
    args = eval_ckpt.parse(["--ckpt", str(root / "port_ckpt"), "--data",
                            str(data), "--frames", str(FRAMES),
                            "--refine_iters", "3", "--device", "cpu"])
    out, diag = eval_ckpt.run(args)
    assert diag == {"renders": {"fwd": 1 + 1 + 4, "bwd": 3},
                    "overflow": 0.0}
    assert np.isfinite(out["psnr_test_pose_refined"])
