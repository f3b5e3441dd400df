"""The comparison's control and planted faults on the card, at a size a
test run holds (``perfbench/control.py`` reads them at a cell's own size):
the program passes the committed limits, and the reference put in its
place in TF32, or with half of the batch left out, or a state left
unchanged, fails one of them."""

import json

import pytest
import torch

from perfbench import check, control
from perfbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cfg34.global", "ref.global"])
def test_control_and_faults_fail_the_limits(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    limits = json.loads((tiny.PERFBENCH / "workloads" / f"{cell}.json"
                         ).read_text())["limits"]
    root, here = tiny.make_root(tmp_path, h=256, w=320)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r in control.readings(cell, [2 ** 31 + 21, 2 ** 31 + 22,
                                         2 ** 31 + 23], device="cuda",
                                  root=root, here=here, log=lambda m: None):
            assert check.judge(r["program"], limits), r
            for fault in ("control", "half_rows", "unchanged"):
                assert not check.judge(r[fault], limits), (fault, r)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
