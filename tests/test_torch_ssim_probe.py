"""The port's SSIM precision probe (``cli.ssim_probe``) against the JAX
package's ``scripts/ssim_probe.py`` on the CPU, at 128x160.

- Its float64 reference (numpy alone) against the JAX script's
  ``f64_ssim_stats`` (scipy) on the script's smooth pair: the same numbers
  to 1e-12 relative (float64 summation order).
- The probe on the CPU: PASS, its pair SSIM against JAX ``ops/ssim.ssim``
  on the same images (2e-6, as tests/test_torch_losses.py) and against
  the JAX script's reference (the probe's 1e-4).
- A blur whose operands are truncated to bf16 (the TPU's fault of rounds
  2 and 4): FAIL and a non-zero exit.
- Without a card and without ``--device cpu`` it raises.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.ops.ssim import ssim as jssim
from freesurgs_tpu_torch.cli import ssim_probe
from freesurgs_tpu_torch.ops import ssim as ssim_mod

from test_torch_viz import one_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--height", "128", "--width", "160"]


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_ssim_probe", REPO / "scripts" / "ssim_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pair():
    return ssim_probe.probe_images(128, 160)


def test_f64_reference_matches_jax_script(jax_script, pair):
    got = ssim_probe.f64_ssim_stats(*pair)
    want = jax_script.f64_ssim_stats(*pair)
    np.testing.assert_allclose(got, [float(v) for v in want], rtol=1e-12)


def test_probe_passes_on_cpu(jax_script, pair, capsys):
    assert ssim_probe.main(SMALL) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["result"] == "PASS" and all(line["checks"].values())
    assert line["device"] == "cpu" and line["den_min"] > 0
    ref_pair, ref_den_min = jax_script.f64_ssim_stats(*pair)
    assert abs(line["ssim_pair"] - float(ref_pair)) < 1e-4
    assert line["ssim_pair_f64"] == pytest.approx(float(ref_pair), rel=1e-12)
    a, b = (jnp.asarray(x) for x in pair)
    assert line["ssim_pair"] == pytest.approx(float(jssim(a, b)), abs=2e-6)


def test_probe_fails_on_truncated_blur(monkeypatch, capsys):
    real_blur = ssim_mod._blur

    def bf16_operands(img, *args):
        return real_blur(img.to(torch.bfloat16).to(torch.float32), *args)

    monkeypatch.setattr(ssim_mod, "_blur", bf16_operands)
    assert ssim_probe.main(SMALL) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["result"] == "FAIL" and not all(line["checks"].values())


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssim_probe.main([])
