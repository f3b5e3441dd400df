"""The port's command line (``io/config.py``, ``cli/train.py``,
``cli/render.py``) against the JAX package's (``io/config.py``, the root
``train.py`` and ``render.py``).

Config: the same flags with the same defaults, the same ``--train_override``
parsing, and a ``config.json`` round trip. End to end: a 3-frame 32x48
SCARED directory from seed 5 (frame 2 the test frame), trained by each CLI
with the overrides of tests/test_torch_global.py (local Pearson and densify
off, small iterations, SH degree 1; the JAX side renders with the dense
oracle, the port on the CPU), then validated from the port's checkpoint and
rendered by each package's render CLI.

Tolerances: the Trainer gate of tests/test_torch_train.py for the exported
PLYs, loaded back into fields of the run's capacity (99% of each
parameter's entries to 1e-5), with the worst entry held at 2e-3 instead of
1e-3: on these 8-bit frames one quaternion component of one Gaussian ends
1.4e-3 apart, 1.4 steps of the rotation learning rate (Adam normalizes a
gradient component that is rounding noise to a full step, the mechanism
that docstring describes); the metric
tolerances of tests/test_torch_global.py for the final validation rows;
panels are 8-bit, truncated from renders that agree to ~1e-5, so decoded
pixels may differ by 1 LSB; cameras.json to 1e-5 like the poses. The port's
validation from its own checkpoint equals its final validation exactly
(restore is bit-exact and the renders deterministic).
"""

import argparse
import ast
import contextlib
import importlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from freesurgs_tpu.data.scared import save_synthetic_as_scared
from freesurgs_tpu.data.synthetic import make_scene
from freesurgs_tpu.io import config as jconfig
from freesurgs_tpu.io.ply import load_ply_arrays
from freesurgs_tpu.io.ply import ply_to_field as jply_to_field
from freesurgs_tpu_torch.cli import render as trender
from freesurgs_tpu_torch.cli import train as ttrain
from freesurgs_tpu_torch.data.scared import load_scared as tload_scared
from freesurgs_tpu_torch.io import config as tconfig
from freesurgs_tpu_torch.io.ply import ply_to_field as tply_to_field
from freesurgs_tpu_torch.io.png import read_png

from test_torch_train import PARAMS, close_params

OVERRIDES = ["tracking_iters=4", "mapping_iters=3",
             "first_frame_mapping_iters=6", "w_local_pearson=0.0",
             "densify_interval=10000", "opacity_reset_interval=13",
             "sh_increase_interval=8", "global_iters=12"]
METRIC_ATOL = {"psnr": 1e-3, "ssim": 1e-5, "ate": 1e-5, "rpe_trans": 1e-5,
               "rpe_rot_deg": 1e-3}


def _parser(mod):
    p = argparse.ArgumentParser()
    mod.add_to_parser(mod.Config(), p)
    return p


def test_config_flags_match_jax():
    """Every JAX flag, with its default, and no other."""
    def flags(mod):
        return {a.dest: a.default for a in _parser(mod)._actions
                if a.dest != "help"}
    assert flags(tconfig) == flags(jconfig)
    args = ["--run_test", "yes", "--run_visualize", "0",
            "--model_init_mask_frac", "0.25", "--data_depth_prior", "metric"]
    assert (vars(_parser(tconfig).parse_args(args))
            == vars(_parser(jconfig).parse_args(args)))


@pytest.mark.parametrize("override", [
    "tracking_iters=7", "w_pearson=0.5", "keyframe_policy=overlap",
    "impl=raster", "rebin_every=4", "tracking_gn_huber_px=3"])
def test_train_override_matches_jax(override):
    argv = ["--train_override", override, "--run_max_instances", "123"]
    j = jconfig.from_args(jconfig.Config(),
                          _parser(jconfig).parse_args(argv))
    t = tconfig.from_args(tconfig.Config(),
                          _parser(tconfig).parse_args(argv))
    assert t.train_overrides == j.train_overrides
    assert type(next(iter(t.train_overrides.values()))) is \
        type(next(iter(j.train_overrides.values())))
    jt, tt = j.train_config()._asdict(), t.train_config()._asdict()
    for k in jt:
        if k != "densify":
            assert tt[k] == jt[k], k
    with pytest.raises(KeyError, match="no_such_field"):
        tconfig.from_args(tconfig.Config(), _parser(tconfig).parse_args(
            ["--train_override", "no_such_field=1"]))


def test_config_json_roundtrip(tmp_path):
    cfg = tconfig.from_args(tconfig.Config(), _parser(tconfig).parse_args(
        ["--data_sample_rate", "4", "--run_platform", "cpu",
         "--train_override", "global_iters=12"]))
    path = str(tmp_path / "config.json")
    tconfig.save_config(cfg, path)
    assert tconfig.load_config(path) == cfg
    assert jconfig.load_config(path).data == jconfig.DataConfig(
        **vars(cfg.data))
    assert cfg.device() == "cpu"
    assert tconfig.Config().device() == "cuda"


@pytest.mark.parametrize("argv,exc,match", [
    ([], RuntimeError, "no CUDA device"),
    (["--run_platform", "tpu"], ValueError, "run_platform"),
    (["--run_platform", "cpu", "--run_impl", "oracle"],
     NotImplementedError, "impl='oracle'")])
def test_cli_refuses(tmp_path, argv, exc, match):
    """No CUDA device (this machine) without --run_platform cpu, an unknown
    platform and the oracle route fail before any work."""
    out = tmp_path / "out"
    base = ["--data_source_path", str(tmp_path), "--run_model_path",
            str(out)]
    for main in (ttrain.main, trender.main):
        with pytest.raises(exc, match=match):
            main(base + argv + ["--run_start_checkpoint", "x"])
    assert not out.exists()


@pytest.mark.parametrize("viser", [False, True])
def test_cli_visualize(tmp_path, monkeypatch, capsys, viser):
    """--run_visualize true: without viser (both machines) cli.train logs
    "viser not installed; running headless" and goes on to the run, as the
    JAX train.py does (here it next fails to find frames in an empty
    directory); with viser importable it refuses before loading any data,
    naming the viewer's ROADMAP item, and logs no headless line."""
    import sys
    import types
    if viser:
        monkeypatch.setitem(sys.modules, "viser", types.ModuleType("viser"))
    else:
        monkeypatch.setitem(sys.modules, "viser", None)
    out = tmp_path / "out"
    argv = ["--data_source_path", str(tmp_path), "--run_model_path",
            str(out), "--run_platform", "cpu", "--run_visualize", "true"]
    if viser:
        with pytest.raises(NotImplementedError, match="item 5"):
            ttrain.main(argv)
        assert "headless" not in capsys.readouterr().out
        assert sorted(p.name for p in out.iterdir()) == ["config.json",
                                                         "metrics.jsonl"]
    else:
        with pytest.raises(FileNotFoundError, match="no frames"):
            ttrain.main(argv)
        assert "viser not installed; running headless" in \
            capsys.readouterr().out


def test_debug_nans_turns_on_anomaly_detection(tmp_path, monkeypatch):
    """--run_debug_nans true runs the job under autograd's anomaly mode
    (the counterpart of jax_debug_nans) and restores the mode after."""
    import torch
    seen = []
    monkeypatch.setattr(ttrain, "run", lambda cfg, logger: seen.append(
        torch.is_anomaly_enabled()) or 0)
    base = ["--data_source_path", str(tmp_path), "--run_model_path",
            str(tmp_path / "out"), "--run_platform", "cpu"]
    assert ttrain.main(base + ["--run_debug_nans", "true"]) == 0
    assert ttrain.main(base) == 0
    assert seen == [True, False] and not torch.is_anomaly_enabled()
    assert (tmp_path / "out" / "config.json").exists()


# ------------------------------------------------------------- end to end

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data, jout, tout = (str(root / n) for n in ("data", "jax", "port"))
    save_synthetic_as_scared(make_scene(num_frames=3, n_gaussians=300,
                                        height=32, width=48, seed=5), data)
    # both CLIs load from one FSC1 cache: a raw load keeps the JSON's f64
    # intrinsics, the cache their f32 rounding (ROADMAP Queue 3)
    tload_scared(data, sample_rate=4)
    common = ["--data_source_path", data, "--data_sample_rate", "4",
              "--model_sh_degree", "1", "--model_capacity", "4096",
              "--run_global_chunk", "4", "--run_checkpoint_every", "8"]
    common += [a for o in OVERRIDES for a in ("--train_override", o)]
    jargs = common + ["--run_model_path", jout, "--run_impl", "oracle"]
    targs = common + ["--run_model_path", tout, "--run_platform", "cpu"]
    jtrain = importlib.import_module("train")
    jrender = importlib.import_module("render")
    from freesurgs_tpu.eval import image_metrics as jim
    jeval = jim.rgb_evaluation
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSTPU_COMPILE_CACHE", "")
        # the JAX render.py rounds every metric, lpips_backend's string
        # included, and raises there (ROADMAP Queue 3): hand it the floats
        mp.setattr(jim, "rgb_evaluation", lambda g, p: {
            k: v for k, v in jeval(g, p).items() if k != "lpips_backend"})
        res = {"jax_train": _run(jtrain.main, jargs),
               "port_train": _run(ttrain.main, targs)}
        final = len(_rows(tout))
        res["port_resume"] = _run(ttrain.main, targs + [
            "--run_start_checkpoint", "latest", "--run_test", "true"])
        for name, main, args, out in (("jax", jrender.main, jargs, jout),
                                      ("port", trender.main, targs, tout)):
            res[f"{name}_render"] = _run(main, args + [
                "--run_start_checkpoint", os.path.join(out, "ckpt_final"),
                "--split", "all"])
    return res, jout, tout, final


def test_cli_train_matches_jax(runs):
    """Both runs complete; the exported clouds, loaded back into fields of
    the run's 4096 slots, agree to the Trainer gate (worst entry at 2e-3,
    see the module docstring)."""
    res, jout, tout, _ = runs
    for k in ("jax_train", "port_train"):
        assert res[k][0] == 0 and "all complete" in res[k][1], k
    jpath, tpath = (os.path.join(o, "point_cloud.ply") for o in (jout, tout))
    assert list(load_ply_arrays(jpath)) == list(load_ply_arrays(tpath))
    jf = jply_to_field(jpath, max_sh_degree=1, capacity=4096)
    tf = tply_to_field(tpath, max_sh_degree=1, capacity=4096, device="cpu")
    assert int(tf.num_active) == int(jf.active.sum()) > 100
    np.testing.assert_array_equal(np.asarray(jf.active), tf.active.numpy())
    for k in PARAMS:
        close_params(getattr(jf, k), getattr(tf, k), k, atol=2e-3)


def test_cli_validation_matches_jax(runs):
    _, jout, tout, final = runs
    j, t = _rows(jout)[-1], _rows(tout)[final - 1]
    for k, atol in METRIC_ATOL.items():
        np.testing.assert_allclose(j[k], t[k], atol=atol, err_msg=k)
    np.testing.assert_allclose(j["lpips"], t["lpips"], rtol=1e-4)
    assert t["overflow"] == 0


def test_cli_resume_validation_equals_final(runs):
    """--run_start_checkpoint latest --run_test true: the validation of
    ckpt_final equals the run's final validation."""
    res, _, tout, final = runs
    rc, log = res["port_resume"]
    assert rc == 0 and "restored" in log and "ckpt_final" in log
    rows = _rows(tout)
    assert len(rows) == final + 1
    for k in ("psnr", "ssim", "lpips", "ate", "rpe_trans", "rpe_rot_deg"):
        assert rows[-1][k] == rows[final - 1][k], k


def test_cli_output_files_match_jax(runs):
    """The same files in both run directories, the same panels (decoded to
    within 1 LSB) and the same config but for the run's own fields."""
    _, jout, tout, _ = runs
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout))
    assert {"config.json", "metrics.jsonl", "point_cloud.ply",
            "ckpt_progressive", "ckpt_final", "ckpt_0000008", "panels",
            "renders", "cameras.json"} <= set(os.listdir(tout))
    panels = sorted(os.listdir(os.path.join(jout, "panels")))
    assert panels == sorted(os.listdir(os.path.join(tout, "panels")))
    assert any(p.startswith("compare_f0000_") for p in panels)
    assert any(p.startswith("val_f0002_") for p in panels)
    for p in panels:
        j = np.asarray(Image.open(os.path.join(jout, "panels", p)), int)
        t = read_png(os.path.join(tout, "panels", p)).astype(int)
        assert j.shape == t.shape and np.abs(j - t).max() <= 1, p
    with open(os.path.join(jout, "config.json")) as f:
        jc = json.load(f)
    with open(os.path.join(tout, "config.json")) as f:
        tc = json.load(f)
    # the run's own fields; the port's validation from its checkpoint
    # wrote its config.json again, as the JAX CLI does
    for k in ("model_path", "impl", "platform", "test", "start_checkpoint"):
        jc["run"].pop(k), tc["run"].pop(k)
    assert jc == tc


def test_cli_render_matches_jax(runs):
    """Every view's render panel within 1 LSB; cameras.json to 1e-5; the
    printed metrics finite."""
    res, jout, tout, _ = runs
    assert res["port_render"][0] == res["jax_render"][0] == 0
    names = sorted(os.listdir(os.path.join(tout, "renders")))
    assert names == ["all_0000.png", "all_0001.png", "all_0002.png"]
    assert names == sorted(os.listdir(os.path.join(jout, "renders")))
    for n in names:
        j = np.asarray(Image.open(os.path.join(jout, "renders", n)), int)
        t = read_png(os.path.join(tout, "renders", n)).astype(int)
        assert j.shape == t.shape and np.abs(j - t).max() <= 1, n
    with open(os.path.join(jout, "cameras.json")) as f:
        jc = json.load(f)
    with open(os.path.join(tout, "cameras.json")) as f:
        tc = json.load(f)
    assert len(jc) == len(tc) == 3
    for a, b in zip(jc, tc):
        for k in ("id", "img_name", "width", "height"):
            assert a[k] == b[k], k
        for k in ("position", "rotation", "fx", "fy"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
    line = [ln for ln in res["port_render"][1].splitlines()
            if ln.startswith("{'psnr'")][-1]
    m = ast.literal_eval(line)
    assert all(np.isfinite(m[k]) for k in ("psnr", "ssim", "lpips"))
