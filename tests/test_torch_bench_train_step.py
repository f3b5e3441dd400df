"""``cli.bench_train_step`` against ``scripts/bench_train_step.py``: 3
two-view mapping steps of the command's state (48x64, 600 Gaussians, SH
degree 3, local Pearson off: its boxes come from each package's own
generator) against JAX ``make_jitted_mapping`` (``pallas_interpret``, the
script's Pallas path on the CPU): every parameter within 1e-4 (the gate of
tests/test_torch_bin_reuse.py), the loss 1e-5 relative; the printed line's
keys are the JAX script's (read from its source) plus ``device``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from freesurgs_tpu.models.gaussians import GaussianField as JField
from freesurgs_tpu.train import steps as js
from freesurgs_tpu.train.optim import adam_init as jadam_init
from freesurgs_tpu_torch.cli import bench_train_step

from test_torch_bench import jcam, jnp_, printed_keys
from test_torch_viz import one_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent


def test_mapping_step_matches_jax(capsys):
    n, hw, deg, iters = 600, (48, 64), 3, 3
    cam, st, colors, monodeps, w2c, cfg = bench_train_step.build(
        n, hw, deg, "cpu", w_local_pearson=0.0)
    f = st.field
    jf = JField(**{k: jnp.asarray(getattr(f, k).numpy()) for k in (
        "means", "quats", "log_scales", "logit_opacity", "sh_dc", "sh_rest",
        "active", "max_radii2d", "grad_accum", "grad_denom",
        "scene_radius")}, max_sh_degree=deg)
    jcfg = js.TrainConfig(max_instances=16_384, impl="pallas_interpret",
                          densify_interval=10**9, w_local_pearson=0.0)
    jst = js.MappingState(jf, jadam_init(jf.param_dict()), jnp.int32(0),
                          jax.random.PRNGKey(0), jnp.zeros((2,) + hw),
                          jnp.zeros((2, 3) + hw))
    mapping = js.make_jitted_mapping(jcam(cam), jcfg)
    jst2, jaux = mapping(jst, *jnp_((colors, monodeps, w2c)),
                         jnp.zeros((iters,), jnp.int32),
                         jnp.zeros((2,), jnp.int32), jnp.int32(1),
                         cam=jcam(cam), cfg=jcfg, two_views=True,
                         sh_degree=deg, densify_enabled=False)
    st2, aux = bench_train_step.run_chunk(st, colors, monodeps, w2c, cam,
                                          cfg, iters, True, deg)
    for k in ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
              "sh_rest"):
        np.testing.assert_allclose(getattr(st2.field, k).numpy(),
                                   np.asarray(getattr(jst2.field, k)),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    assert float(aux["overflow_max"]) == 0

    assert bench_train_step.main(["--n", "600", "--hw", "48", "64",
                                  "--iters", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == (printed_keys(REPO / "scripts/bench_train_step.py")
                         | {"device"})
    assert line["metric"] == "mapping_step_mpix_per_s"
    assert line["two_views"] is False and line["device"] == "cpu"
