"""The port's bench (``freesurgs_tpu_torch.bench``) against the root
``bench.py`` at its CPU shapes, where the port runs the kernels' plain
versions; and every measuring program's refusal to run without a card
(``bench``, ``cli.bench_train_step``, ``cli.stage_timing``,
``cli.eval_ckpt``). The mapping-step bench and stage timing are held
against their JAX scripts in tests/test_torch_bench_train_step.py and
tests/test_torch_stage_timing.py.

- Bench, at ``bench.py``'s CPU shapes (64x64, 2,000 Gaussians, SH degree
  0): the first step's loss and its five gradients against JAX
  ``render(impl="oracle")`` on the same numpy inputs (loss 2e-5 relative,
  the pixel gate; gradients 5e-5 after normalizing by their largest
  magnitude); 4 amortized steps on a carried layout against JAX's
  ``render(bins=, rebin=)`` (``pallas_interpret``) at
  tests/test_torch_bin_reuse.py's gate (2e-5), with one binning; the
  printed line's keys are ``bench.py``'s (read from its source) plus the
  port's.
- Without a card each entry point raises unless ``--device cpu`` is given.
"""

import ast
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.ops import raster_pallas as jrp
from freesurgs_tpu.ops.render import raster_config as jraster_config
from freesurgs_tpu.ops.render import render as jrender
from freesurgs_tpu_torch import bench
from freesurgs_tpu_torch.ops import raster_cuda as rc

from test_torch_viz import one_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
PORT_BENCH_KEYS = {"device", "iters", "ms_per_iter_median",
                   "median_samples", "device_busy_share", "step_costs",
                   "rates_after_tracing"}
GRAD_TOL = 5e-5


def printed_keys(path: Path) -> set[str]:
    """The constant keys of the dict a script hands ``json.dumps``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps of a dict in {path}")


def jcam(cam):
    return JCam(height=cam.height, width=cam.width, fx=cam.fx, fy=cam.fy,
                cx=cam.cx, cy=cam.cy)


def jnp_(ts):
    return [jnp.asarray(t.detach().numpy()) for t in ts]


def normalized_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def jbench_loss(out):
    return jnp.mean(out["render"] ** 2) + 0.1 * jnp.mean(out["render_dep"])


@pytest.fixture(scope="module")
def cpu_bench():
    return bench.Bench("cpu", bench.CPU_SHAPES)


# ----------------------------------------------------------------- bench

def test_bench_scene_is_bench_py_recipe(cpu_bench):
    """bench.py's CPU branch draws these arrays (seed 0, SH degree 0)."""
    rng = np.random.default_rng(0)
    n = 2_000
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(0.8, 4.0, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    log_scales = np.log(rng.uniform(0.004, 0.012, (n, 3))).astype(np.float32)
    logit_op = rng.uniform(-2, 2, n).astype(np.float32)
    sh = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3
    for got, want in zip(cpu_bench.params,
                         (means, quats, log_scales, logit_op, sh)):
        assert np.array_equal(got.numpy(), want)
    cam = cpu_bench.cam
    assert (cam.height, cam.width, cam.fx, cam.cx) == (64, 64, 64 * 0.78, 32)


def test_first_step_matches_jax_oracle(cpu_bench):
    loss, grads, bins = cpu_bench.grad_step(cpu_bench.params[0])
    assert bins is None
    args = jnp_(cpu_bench.params)
    cam = jcam(cpu_bench.cam)

    def jloss(*p):
        return jbench_loss(jrender(*p, jnp.eye(4), cam, sh_degree=0,
                                   impl="oracle"))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(*args)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5)
    for name, g, want in zip(("means", "quats", "log_scales",
                              "logit_opacity", "sh"), grads, jg):
        assert normalized_err(g, want) <= GRAD_TOL, name


def test_amortized_steps_match_jax_carry(cpu_bench):
    """4 steps rebinning every 4: one binning, and each step's loss on the
    carried layout is JAX's on its carried BinState."""
    rc.reset_bins()
    _, losses, grads, _ = cpu_bench.steps(4, bench.REBIN_EVERY)
    assert rc.BINS["build_tile_bins"] == 1
    args = jnp_(cpu_bench.params)
    cam = jcam(cpu_bench.cam)
    maxi = 8_192                       # bench.py's CPU capacity
    bins = jrp.zero_bin_state(2_000, jraster_config(
        cam, maxi, 2_000, "pallas_interpret"))

    @jax.jit
    def jstep(m, bins, rebin):
        def loss(m):
            out = jrender(m, *args[1:], jnp.eye(4), cam, sh_degree=0,
                          impl="pallas_interpret", max_instances=maxi,
                          bins=bins, rebin=rebin)
            return jbench_loss(out), out["bins"]
        (l, bins), g = jax.value_and_grad(loss, has_aux=True)(m)
        return l, bins, m + 0.0 * g

    m = args[0]
    for i, loss in enumerate(losses):
        jl, bins, m = jstep(m, bins, jnp.bool_(i % bench.REBIN_EVERY == 0))
        np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5,
                                   err_msg=f"step {i}")
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_bench_line_has_bench_py_keys(monkeypatch, capsys):
    # the CPU branch's flow on a smaller scene: the line, not the rate
    monkeypatch.setattr(bench, "CPU_SHAPES", dict(height=32, width=32,
                                                  n=300, sh_degree=0))
    assert bench.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == printed_keys(REPO / "bench.py") | PORT_BENCH_KEYS
    assert line["metric"] == "render_fwdbwd_mpix_per_s"
    assert line["amortized_rebin_every"] == 4
    assert line["device"] == "cpu" and line["device_busy_share"] is None
    assert line["median_samples"] == line["iters"] == bench.ITERS
    assert line["value"] > 0 and line["amortized_train_mpix_per_s"] > 0
    # a fresh window, and an amortized one's binning and carried steps
    steps = {k: v["steps"] for k, v in line["step_costs"].items()}
    assert steps == {"fresh": 8, "rebin": 2, "carried": 6}
    assert all(v["wall_ms"] > 0 and v["host_syncs"] is None
               and v["device_ms"] is None
               for v in line["step_costs"].values())
    assert line["rates_after_tracing"] is None


def test_timed_windows_precede_tracing(monkeypatch):
    """Both rates are timed before the passes that trace or count syncs
    (``device_time``, ``step_costs``): on the card a window timed after
    them ran up to a third slower, which put the amortized rate, timed
    after the profiler, below the raw one."""
    calls = []
    monkeypatch.setattr(bench, "CPU_SHAPES", dict(height=32, width=32,
                                                  n=300, sh_degree=0))
    monkeypatch.setattr(
        bench.Bench, "best_window",
        lambda self, iters, rebin_every=None, reps=3:
        calls.append(("window", rebin_every)) or 0.01)
    monkeypatch.setattr(
        bench.Bench, "steps",
        lambda self, iters, rebin_every=None, sync_each=False:
        (None, [], [], [0.01] * iters))
    monkeypatch.setattr(bench, "device_time",
                        lambda fn, dev: calls.append("trace"))
    monkeypatch.setattr(bench, "step_costs",
                        lambda b, iters, rebin_every=None:
                        calls.append("costs") or {}, raising=False)
    bench.run("cpu")
    assert calls == [("window", None), ("window", bench.REBIN_EVERY),
                     "trace", "costs", "costs"]


# ------------------------------------------------------------- no card

@pytest.mark.parametrize("module, argv", [
    ("freesurgs_tpu_torch.bench", []),
    ("freesurgs_tpu_torch.cli.bench_train_step", []),
    ("freesurgs_tpu_torch.cli.stage_timing", []),
    ("freesurgs_tpu_torch.cli.eval_ckpt", ["--ckpt", "c", "--data", "d"]),
])
def test_entry_points_raise_without_a_card(monkeypatch, module, argv):
    """Without a card and without ``--device cpu`` each raises before any
    work: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).main(argv)
