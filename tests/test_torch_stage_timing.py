"""``cli.stage_timing`` against ``scripts/stage_timing.py`` at 48x64 with
600 Gaussians of the bench recipe (SH degree 3), on the CPU:

- stage 1's scalar (2e-5 relative), the forward's mean (2e-5) and the
  backward stage's gradient (5e-5 after normalizing by its largest
  magnitude; its sum within 5e-5 of the sum of magnitudes) against the JAX
  script's stage functions, with JAX ``render(impl="oracle")``;
- stages 2-3 against JAX's sort binner (``ops/binning.py build_tile_bins``
  at 32 px bins, after its pre-prune and snug rects) and its records
  (``_field_cols`` / ``_build_feat``), slot for slot: the layout and the
  packed rects bitwise, the records' values to 1e-6 (the two projections
  round differently in the last bit);
- the printed line: every stage in order, host times only on the CPU;
  ``--bin-tile`` other than 32 raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.sh import sh_to_rgb_clamped as jsh_rgb
from freesurgs_tpu.ops import raster_pallas as jrp
from freesurgs_tpu.ops.binning import build_tile_bins as jbuild_tile_bins
from freesurgs_tpu.ops.binning import derive_bin_rect as jderive_bin_rect
from freesurgs_tpu.ops.projection import project_gaussians as jproject
from freesurgs_tpu.ops.render import render as jrender
from freesurgs_tpu_torch import bench
from freesurgs_tpu_torch.cli import stage_timing
from freesurgs_tpu_torch.ops.render import render as trender

from test_torch_bench import (GRAD_TOL, jbench_loss, jcam, jnp_,
                              normalized_err)
from test_torch_viz import one_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def stages():
    cam, params = bench.bench_scene("cpu", height=48, width=64, n=600,
                                    sh_degree=3)
    fns, renders, parts = stage_timing.stage_fns(cam, params, 3)
    return cam, params, fns, renders, parts


def test_stage_scalars_match_jax(stages):
    cam, params, fns, renders, _ = stages
    assert list(fns) == list(stage_timing.STAGES)
    assert [renders[s] for s in stage_timing.STAGES] == [
        (0, 0), (0, 0), (0, 0), (1, 0), (1, 1)]
    m, q, s, o, c = jnp_(params)
    jc = jcam(cam)
    p = jproject(m, jnp.exp(s), q, jc)
    np.testing.assert_allclose(
        float(fns["projection"](params[0])),
        float(jnp.sum(p.mean2d[:, 0]) + jnp.sum(p.depth)), rtol=2e-5)

    def jout(m):
        return jrender(m, q, s, o, c, jnp.eye(4), jc, sh_degree=3,
                       impl="oracle")

    np.testing.assert_allclose(float(fns["full fwd"](params[0])),
                               float(jnp.mean(jout(m)["render"])), atol=2e-5)
    jg = jax.grad(lambda m: jbench_loss(jout(m)))(m)
    mt = params[0].detach().requires_grad_(True)
    out = trender(mt, *params[1:], torch.eye(4), cam, sh_degree=3)
    g = torch.autograd.grad(bench.bench_loss(out), mt)[0]
    assert normalized_err(g, jg) <= GRAD_TOL
    assert abs(float(fns["fwd+bwd"](params[0])) - float(jnp.sum(jg))) <= (
        GRAD_TOL * float(jnp.sum(jnp.abs(jg))))


def test_stage_binning_and_records_are_jax_layout(stages):
    """Stages 2-3 bin and gather what JAX's sort binner does at 32 px
    bins, slot for slot; the port's buffer is exactly the padded total,
    JAX's the capacity (its tail is padding)."""
    cam, params, _, _, parts = stages
    m, q, s, o, c = jnp_(params)
    jc = jcam(cam)
    cap = 16_384
    cfg = jrp.RasterConfig(height=cam.height, width=cam.width,
                           max_instances=cap, interpret=True,
                           fast_binning=False, bin_tile=32)
    opac = jax.nn.sigmoid(o)
    pb = jrp._prune_and_snug(jproject(m, jnp.exp(s), q, jc), opac)
    jb = jbuild_tile_bins(jderive_bin_rect(pb, cfg.bin_scale), cfg.grid_x,
                          cfg.grid_y, cap)
    dirs = m * jax.lax.rsqrt(jnp.maximum(jnp.sum(m * m, -1, keepdims=True),
                                         1e-16))
    rgbz = jnp.concatenate([jsh_rgb(3, c, dirs), pb.depth[:, None]], 1)
    jfeat, _ = jrp._build_feat(jrp._field_cols(
        pb.mean2d, pb.conic, rgbz, opac, pb.tile_rect, cfg), jb)
    _, bins = parts["binned"](params[0])
    feat, rect, bins3 = parts["records"](params[0])
    M = bins.gather_idx.shape[0]
    for b in (bins, bins3):
        np.testing.assert_array_equal(b.gather_idx.numpy(),
                                      np.asarray(jb.gather_idx)[:M])
        np.testing.assert_array_equal(b.tile_start.numpy(),
                                      np.asarray(jb.tile_start))
        np.testing.assert_array_equal(b.tile_count.numpy(),
                                      np.asarray(jb.tile_count))
    assert np.all(np.asarray(jb.gather_idx)[M:] == 600)
    assert int(bins.num_instances) == int(jb.num_instances) > 0
    assert int(bins.overflow) == int(jb.overflow) == 0
    jfeat = np.asarray(jfeat)[:, :M]
    np.testing.assert_allclose(feat.numpy(), jfeat[:10], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(rect.numpy(), jfeat[10].view(np.int32))


def test_stage_timing_prints_every_stage(capsys):
    assert stage_timing.main(["--n", "600", "--hw", "48", "64", "--iters",
                              "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["stage"] for r in line["stages"]] == list(stage_timing.STAGES)
    assert all(r["ms"] is None and r["kernel_ms"] is None and r["host_ms"] > 0
               for r in line["stages"])
    assert line["device"] == "cpu" and line["bin_tile"] == 32
    with pytest.raises(ValueError, match="ROADMAP Queue 3"):
        stage_timing.main(["--bin-tile", "16", "--device", "cpu"])
