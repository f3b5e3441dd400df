"""``cli.make_fullres_dataset`` and ``cli.run_config34`` against the JAX
package's ``scripts/make_fullres_dataset.py`` and ``scripts/run_config34.py``.

- The recipe on 3 frames at 32x48 (its seed and scales, 1,500 Gaussians):
  the same files as JAX ``make_scene(impl="oracle")`` written by JAX
  ``save_synthetic_as_scared``, frames within 1 LSB (8-bit truncation of
  renders that agree to ~1e-6), poses equal, flows within 1e-4 px and
  disparities within 1e-5 relative (float32 reassociation); ``--nonrigid``
  writes ``nonrigid_mask.npz`` with the JAX script's keys and dtypes.
- run_config34 on a 5-frame fixture of the recipe (frame 4 the test
  frame), with the TrainConfig depth cut to a few iterations: the summary
  keys are the JAX script's (read from its full-scale record,
  results/cfg34_r5c_summary.json); chunking, checkpoints, ``--save_ckpt``
  (PLY = the final field), ``--budget_s 0``, ``--resume``,
  ``--use_gt_poses`` (ATE ~ 0) and a failing ``--pose_ba_final`` (raises,
  ``summary.json`` already written).
- ``cli.fullscale``'s wiring with the card's calls stubbed and its
  commands cut to those sizes: ``--seed`` reaches the dataset and
  ``cli.eval_ckpt``'s line on ``ckpt_final`` lands in ``--results``.
"""

import functools
import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from freesurgs_tpu.data.scared import save_synthetic_as_scared as jsave
from freesurgs_tpu.data.synthetic import make_scene as jmake_scene
from freesurgs_tpu_torch.cli import eval_ckpt, fullscale
from freesurgs_tpu_torch.cli import make_fullres_dataset as mfd
from freesurgs_tpu_torch.cli import run_config34 as rc34
from freesurgs_tpu_torch.io.checkpoint import restore_checkpoint
from freesurgs_tpu_torch.io.ply import ply_to_field
from freesurgs_tpu_torch.io.png import read_png
from freesurgs_tpu_torch.train import loop, steps

from test_torch_viz import one_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
JAX_KEYS = set(json.loads(
    (REPO / "results" / "cfg34_r5c_summary.json").read_text()))
VAL_KEYS = JAX_KEYS & {"psnr", "ssim", "lpips", "lpips_backend",
                       "psnr_train", "ate", "rpe_trans", "rpe_rot_deg"}
# scripts/run_config34.py:235-243
BA_KEYS = ({"pose_ba_final_passes", "pose_ba_polish", "pose_ba_s"}
           | {"ba_" + k for k in VAL_KEYS})
RESUME_KEYS = {"resumed_from", "resumed_at_global_iter"}
SMALL = ["--hw", "32", "48", "--device", "cpu"]
FAST = functools.partial(steps.TrainConfig, tracking_iters=2,
                         mapping_iters=2, first_frame_mapping_iters=3)


def files(root) -> list[str]:
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*"), recursive=True) if os.path.isfile(p))


def test_make_fullres_dataset_matches_jax(tmp_path):
    stats = mfd.main(["--out", str(tmp_path / "t"), "--frames", "3",
                      "--n", "1500"] + SMALL, log=lambda s: None)
    assert stats["overflow_total"] == 0 and stats["num_instances_max"] > 0
    scene = jmake_scene(num_frames=3, n_gaussians=1500, height=32, width=48,
                        seed=7, impl="oracle", scale_range=(0.004, 0.012))
    jsave(scene, str(tmp_path / "j"))
    names = files(tmp_path / "t")
    assert names == files(tmp_path / "j") and len(names) == 13
    for name in names:
        got, want = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".png"):
            a = read_png(str(got)).astype(np.int16)
            b = read_png(str(want)).astype(np.int16)
            assert np.abs(a - b).max() <= 1, name
        elif name.endswith(".npz"):
            with np.load(got) as a, np.load(want) as b:
                assert a["pred"].dtype == b["pred"].dtype == np.float32
                if name.startswith("flow"):
                    np.testing.assert_allclose(a["pred"], b["pred"], rtol=0,
                                               atol=1e-4)
                else:
                    np.testing.assert_allclose(a["pred"], b["pred"],
                                               rtol=1e-5)
        else:
            a, b = json.loads(got.read_text()), json.loads(want.read_text())
            assert a == b, name


def test_make_fullres_dataset_nonrigid_masks(tmp_path):
    mfd.main(["--out", str(tmp_path), "--frames", "3", "--n", "400",
              "--nonrigid"] + SMALL, log=lambda s: None)
    with np.load(tmp_path / "nonrigid_mask.npz") as z:
        got = {k: (z[k].dtype, z[k].shape) for k in z.files}
    assert got == {"nonrigid_mask": (np.dtype(bool), (3, 32, 48)),
                   "member_patch": (np.dtype(np.float16), (3, 32, 48)),
                   "member_spec": (np.dtype(np.float16), (3, 32, 48))}


@pytest.mark.parametrize("which", ["make_fullres_dataset", "run_config34",
                                   "fullscale"])
def test_entry_points_need_a_card(tmp_path, monkeypatch, which):
    """Without --device they run on the card, and raise where there is
    none instead of running on the CPU (fullscale runs only on the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "run_config34":
            rc34.main(["--data", str(tmp_path), "--out", str(tmp_path)])
        elif which == "fullscale":
            fullscale.main(["--results", str(tmp_path / "results")])
        else:
            mfd.main(["--out", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fullres")
    mfd.main(["--out", str(root), "--frames", "5", "--n", "400"] + SMALL,
             log=lambda s: None)
    return root


def run34(data, out, *extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rc34, "TrainConfig", FAST)
        code = rc34.main(["--data", str(data), "--out", str(out),
                          "--frames", "5", "--depth_prior", "metric",
                          "--global_iters", "6", "--global_chunk", "4",
                          "--pose_ba_iters", "2", "--device", "cpu",
                          *extra])
    assert code == 0
    return json.loads((out / "summary.json").read_text())


def global_rows(out) -> list[int]:
    rows = [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    return [r["iter"] for r in rows if r.get("stage") == "global"]


@pytest.fixture(scope="module")
def main_run(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("cfg34")
    summary = run34(data, out, "--checkpoint_every", "4", "--save_ckpt",
                    "--pose_ba_final", "1")
    return out, summary


def test_summary_keys(main_run):
    out, summary = main_run
    assert set(summary) == JAX_KEYS
    ba = json.loads((out / "summary_ba.json").read_text())
    assert set(ba) == JAX_KEYS | BA_KEYS
    assert {k: ba[k] for k in summary} == summary
    assert summary["global_iters_done"] == 6
    assert summary["max_instances"] == summary["final_max_instances"] == 0
    assert summary["lpips_backend"] == "random_features"
    assert all(np.isfinite(summary[k]) for k in ("psnr", "ssim", "ate"))


def test_chunks_checkpoints_and_exports(main_run):
    """Global chunks of 4 then 2 (the cadence's total carries over), a
    checkpoint at 4, ckpt_final, the PLY of the final field and one
    cameras.json record per frame."""
    out, _ = main_run
    assert global_rows(out) == [4, 6]
    for name in ("ckpt_0000004", "ckpt_final", "cameras.json"):
        assert (out / name).exists()
    assert len(json.loads((out / "cameras.json").read_text())) == 5
    tree, _ = restore_checkpoint(str(out / "ckpt_final"))
    fld = tree["state"]["field"]
    act = fld["active"]
    ply = ply_to_field(str(out / "point_cloud.ply"), device="cpu",
                       max_sh_degree=int(fld["max_sh_degree"]))
    assert ply.capacity == int(act.sum())
    for k in ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
              "sh_rest"):
        assert torch.equal(getattr(ply, k), fld[k][act]), k


def test_resume(data, main_run, tmp_path, monkeypatch):
    """--resume skips the progressive stage and continues the global stage
    from the checkpoint's iteration, its frame draws from a stream seeded
    seed + 1 + that iteration (the JAX script's offset)."""
    out, _ = main_run
    seeds = []
    real_rng = np.random.default_rng

    def rng(seed=None):
        seeds.append(seed)
        return real_rng(seed)
    monkeypatch.setattr(np.random, "default_rng", rng)
    summary = run34(data, tmp_path, "--resume", str(out / "ckpt_0000004"))
    assert set(summary) == JAX_KEYS | RESUME_KEYS
    assert summary["resumed_from"] == str(out / "ckpt_0000004")
    assert summary["resumed_at_global_iter"] == 4
    assert summary["global_iters_done"] == 6
    assert summary["progressive_s"] == 0.0
    assert global_rows(tmp_path) == [6]
    assert 6666 + 1 + 4 in seeds


def test_use_gt_poses(data, tmp_path):
    """Ground-truth poses injected and tracking off: the pose metrics are
    zero up to float32 rounding."""
    summary = run34(data, tmp_path, "--use_gt_poses", "--global_iters", "2")
    assert summary["use_gt_poses"] is True
    assert summary["ate"] < 1e-5 and summary["rpe_trans"] < 1e-5
    assert summary["rpe_rot_deg"] < 1e-3


def test_budget_zero_then_failing_pose_ba_final(data, tmp_path,
                                                monkeypatch):
    """``--budget_s 0`` runs no global iteration; a failure in the final
    pose BA is not caught (the JAX script logs it and exits 0): it
    propagates after summary.json is on disk."""
    def boom(self, total):
        raise RuntimeError("pose BA failed")
    monkeypatch.setattr(loop.Trainer, "_pose_ba_pass", boom)
    with pytest.raises(RuntimeError, match="pose BA failed"):
        run34(data, tmp_path, "--budget_s", "0", "--pose_ba_final", "1")
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert set(summary) == JAX_KEYS
    assert summary["global_iters_done"] == 0 and global_rows(tmp_path) == []
    assert not (tmp_path / "summary_ba.json").exists()


@pytest.mark.parametrize("missing", ["--data", "--out"])
def test_run_config34_needs_data_and_out(tmp_path, missing):
    """--data and --out have no default (the JAX script's are fixed paths
    under /tmp, shared by every checkout on a machine)."""
    argv = {"--data": str(tmp_path), "--out": str(tmp_path / "run")}
    del argv[missing]
    with pytest.raises(SystemExit):
        rc34.parse([a for kv in argv.items() for a in kv]
                   + ["--device", "cpu"])
    assert not (tmp_path / "run").exists()


def stub_device(monkeypatch) -> None:
    """``cli.fullscale``'s calls to the card, stubbed."""
    monkeypatch.setattr(fullscale, "device_label", lambda dev: "stub")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("reset_peak_memory_stats", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)


def stub_card(monkeypatch, seen: dict) -> None:
    """Run ``cli.fullscale``'s commands on the CPU at the sizes above (5
    frames at 32x48, the TrainConfig depth cut, 2 global iterations, 2
    refinement iterations), recording each command's parsed arguments in
    ``seen``; the card's calls are stubbed (``stub_device``)."""
    real_mfd, real_rc34, real_eval = mfd.main, rc34.main, eval_ckpt.run

    def fake_mfd(argv):
        seen["make_fullres_dataset"] = a = mfd.parse(argv)
        return real_mfd(["--out", a.out, "--frames", "5", "--n", "400",
                         "--seed", str(a.seed)] + SMALL)

    def fake_rc34(argv):
        seen["run_config34_argv"] = list(argv)
        seen["run_config34"] = a = rc34.parse(argv)
        return real_rc34([
            "--data", a.data, "--out", a.out, "--frames", "5",
            "--depth_prior", a.depth_prior, "--rebin_every",
            str(a.rebin_every), "--tracking_gn_iters",
            str(a.tracking_gn_iters), "--global_iters", "2",
            "--global_chunk", "2", "--pose_ba_iters", "2", "--save_ckpt",
            "--pose_ba_final", str(a.pose_ba_final), "--pose_ba_every",
            str(a.pose_ba_every and 2), "--device", "cpu"])

    def fake_eval(args):
        seen["eval_ckpt"] = dict(vars(args))
        args.frames, args.refine_iters, args.device = 5, 2, "cpu"
        return real_eval(args)

    monkeypatch.setattr(mfd, "main", fake_mfd)
    monkeypatch.setattr(rc34, "main", fake_rc34)
    monkeypatch.setattr(rc34, "TrainConfig", FAST)
    monkeypatch.setattr(eval_ckpt, "run", fake_eval)
    stub_device(monkeypatch)


def test_fullscale_seed_and_evaluation(tmp_path, monkeypatch):
    """``cli.fullscale --seed 8``: the seed reaches
    ``cli.make_fullres_dataset``, and ``cli.eval_ckpt`` evaluates the run's
    ``ckpt_final`` on its dataset, its line (the validation again, and the
    pose-refined test PSNR) written as ``eval_ckpt.json`` beside the
    summaries (``stub_card``)."""
    seen = {}
    stub_card(monkeypatch, seen)

    results = tmp_path / "results"
    assert fullscale.main(["--results", str(results), "--seed", "8"]) == 0
    assert seen["make_fullres_dataset"].seed == 8
    data = Path(seen["make_fullres_dataset"].out)
    assert seen["run_config34"].data == str(data)
    assert seen["eval_ckpt"]["ckpt"] == str(
        Path(seen["run_config34"].out) / "ckpt_final")
    assert seen["eval_ckpt"]["data"] == str(data)
    assert seen["eval_ckpt"]["frames"] == seen["run_config34"].frames == 46
    line = json.loads((results / "eval_ckpt.json").read_text())
    summary = json.loads((results / "summary.json").read_text())
    assert np.isfinite(line["psnr_test_pose_refined"])
    assert line["refine_iters"] == 2
    # the evaluation restores the run's final state: its validation is
    # the run's final one
    assert all(line[k] == summary[k] for k in ("psnr", "ssim", "ate"))
    assert summary["make_fullres_dataset_argv"][2:4] == ["--seed", "8"]
    assert not data.exists()                 # the work directory is gone


# Arm A's run_config34 command line, as its recorded runs ran it
ARM_A = ["--frames", "46", "--depth_prior", "metric", "--rebin_every", "4",
         "--global_iters", "30000", "--global_chunk", "250",
         "--tracking_gn_iters", "8", "--save_ckpt", "--pose_ba_final", "1",
         "--budget_s", "2700", "--device", "cuda"]


@pytest.mark.parametrize("every", [None, 0, 2500])
def test_fullscale_pose_ba_every_argv(tmp_path, monkeypatch, every):
    """``cli.fullscale --pose_ba_every N`` reaches ``cli.run_config34``'s
    command line (cfg34_r5b's arm at 2500); by default, and at 0, that
    command line is Arm A's as it was."""
    seen = {}
    monkeypatch.setattr(mfd, "main", lambda argv: {})
    monkeypatch.setattr(rc34, "main",
                        lambda argv: seen.setdefault("argv", argv) and 0)
    stub_device(monkeypatch)
    argv = ["--results", str(tmp_path / "results")]
    if every is not None:
        argv += ["--pose_ba_every", str(every)]
    assert fullscale.main(argv) == 0
    got = seen["argv"]
    assert got[0] == "--data" and got[2] == "--out"
    assert got[4:] == ARM_A + (["--pose_ba_every", "2500"] if every else [])
    assert rc34.parse(got).pose_ba_every == (every or 0)
    summary = json.loads((tmp_path / "results" / "summary.json").read_text())
    assert summary["run_config34_argv"] == got
    assert summary["pose_ba_passes"] == []


def test_fullscale_records_pose_ba_passes(tmp_path, monkeypatch):
    """``cli.fullscale --pose_ba_every N`` (``stub_card``: N becomes 2 of
    the 2 global iterations) records the Trainer's row of each pose-BA
    pass, the mid-global one and the final one, as metrics.jsonl holds it:
    its iteration, seconds, and the mean start and returned losses, the
    returned never above the start (the monotone guard)."""
    seen = {}
    stub_card(monkeypatch, seen)
    results = tmp_path / "results"
    assert fullscale.main(["--results", str(results), "--pose_ba_every",
                           "2500"]) == 0
    assert seen["run_config34"].pose_ba_every == 2500
    summary = json.loads((results / "summary.json").read_text())
    passes = summary["pose_ba_passes"]
    assert [p["iter"] for p in passes] == [2, 2]      # mid-global, final
    for p in passes:
        assert p["mean_loss"] <= p["start_mean_loss"]
        assert np.isfinite(p["seconds"]) and p["seconds"] >= 0
    rows = [json.loads(ln) for ln in
            (results / "metrics.jsonl").read_text().splitlines()]
    assert passes == [r for r in rows if r.get("stage") == "pose_ba"]
