"""The projection's kernels (``csrc/project.cu``) against their plain
version on the card: chip_smoke.py's ``project`` phase as a test. Marked
``card``: it skips without a CUDA card. It lives outside ``tests/``, whose
conftest sets up JAX, so that it runs on the card's machine, which has no
JAX:

    python -m pytest tests_card -m card -q
"""

import pytest
import torch


@pytest.mark.card
def test_project_kernels_on_card():
    """At the benchmark's size and on the CPU tests' edge scene: integer
    outputs bit-equal to the plain version, float outputs and every
    gradient within their gates, two launches bitwise equal; a mapping
    render launches each kernel once, a tracking render the pose's
    reduction too (the phase's checks raise otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    import chip_smoke
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    rc.build_kernels()
    row = chip_smoke.project_checks(torch.device("cuda", 0))
    assert row["rect_mismatches"] == 0 and row["bitwise_repeat"]
    assert row["render_launches"]["project_fwd"] == 1
    assert row["render_launches"]["project_bwd"] == 1
    assert row["render_launches"]["project_pose"] == 0
    assert row["tracking_render_launches"]["project_pose"] == 1
    assert all(e["int_mismatches"] == 0 for e in row["edge_scene"].values())
