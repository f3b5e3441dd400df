"""The non-rigid cell (``nonrigid.progressive``) through the harness on the
CPU at a tiny size: a traced run reads correct and reports PnP's span
metric (the device metrics need the card), the join of the tracking spans
with a synthetic device trace, and faults planted in the program that read
not correct; on the card, the control and the planted faults against the
committed limits at a size a test run holds."""

import json
import time

import pytest
import torch

from perfbench import check, control, run, spans_tracking
from perfbench.tests import tiny

CELL = "nonrigid.progressive"
CONFIG = "scared_cfg34_nonrigid_pnp"
SEED = 2 ** 31 + 57


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root(tmp_path, h=48, w=64):
    """The tiny benchmark with the non-rigid configuration (its motions
    scaled by 1280 / width, so that they move as many pixels as at
    1280x1024), 3 tracking and mapping steps a frame (2 checked), window
    frames 2-4 (test frame 4), checked frame 5."""
    root, here = tiny.make_root(tmp_path, h=h, w=w)
    sp = root / "perfbench" / "configs" / f"{CONFIG}.json"
    spec = json.loads(sp.read_text())
    nr = json.loads((tiny.PERFBENCH / "configs" / f"{CONFIG}.json"
                     ).read_text())["scene"]["nonrigid"]
    nr["patch_amp"] *= 1280 / w
    nr["spec_speed"] *= 1280 / w
    spec["scene"]["nonrigid"] = nr
    spec["train"].update(tracking_iters=3, mapping_iters=3)
    sp.write_text(json.dumps(spec))
    tp = here / "traffic" / "progressive_nonrigid.json"
    traffic = json.loads(tp.read_text())
    traffic.update(window_frames=[2, 4], trace_frames=[2, 4], check_frame=5,
                   check_tracking_steps=2, check_mapping_steps=2)
    tp.write_text(json.dumps(traffic))
    return root, here


def _run(tmp_path, capsys, trace=0):
    root, here = _root(tmp_path)
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.1", "--trace", str(trace)], device="cpu", root=root,
                  here=here, t_start=time.time())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_traced_run_is_correct_and_reads_pnp_spans(tmp_path, capsys):
    out = _run(tmp_path, capsys, trace=1)
    assert out["correct"], out["check"]
    assert out["attempted"] == 3 and out["failed"] == 0
    assert "pnp_pose_gap" in out["check"]
    # on the CPU the trace holds no kernel: the device metrics stay out
    assert set(out["metrics"]) == {"pnp_ms_per_frame.nonrigid"}
    assert out["metrics"]["pnp_ms_per_frame.nonrigid"]["value"] > 0


def _span(i, name, s, e, parent=0, tid=1):
    from freesurgs_tpu_torch.utils.profiling import Span
    return Span(i, name, s, e, tid, parent, None)


def test_join_puts_kernels_and_gaps_down_to_the_tracking_layers():
    """A frame: track [0, 100) holding track.init [0, 20), track.mask
    [20, 30), track.iter [30, 90) with a render's ``raster`` under it;
    then map.iter [100, 150). Kernels launched in each, the gaps after
    them, and a blocking call in track.init."""
    spans = [_span(1, "track", 0, 100), _span(2, "track.init", 0, 20, 1),
             _span(3, "track.mask", 20, 30, 1),
             _span(4, "track.iter", 30, 90, 1),
             _span(5, "raster", 40, 80, 4), _span(6, "map.iter", 100, 150)]
    evs, corr = [], 0

    def kernel(t_launch, s, e, name="k"):
        nonlocal corr
        corr += 1
        evs.append(("cudaLaunchKernel", False, t_launch, t_launch + 1,
                    (1, 1), corr))
        evs.append((name, True, s, e, (0, 0), corr))

    kernel(2, 5, 10)                   # track.init, then a gap to 21
    evs.append(("cudaStreamSynchronize", False, 11, 12, (1, 1), 0))
    kernel(21, 21, 25)                 # track.mask
    kernel(41, 41, 60, "own_kernel")   # raster under track.iter
    kernel(101, 101, 140)              # map.iter
    j = spans_tracking.join(evs, spans, {1: 1}, 1, 150e-6, {"own_kernel"})
    lay = j["layers"]
    assert lay["track.init"]["dev_ms"] == pytest.approx(5e-6)
    assert lay["track.init"]["syncs"] == 1
    assert lay["track.mask"]["dev_ms"] == pytest.approx(4e-6)
    assert lay["track.iter"]["dev_ms"] == pytest.approx(19e-6)
    assert lay["track.iter"]["torch_dev_ms"] == 0.0
    assert lay["map.iter"]["launches"] == 1
    # gaps: 10-21 after track.init's launch, 25-41 after track.mask's,
    # 60-101 after raster's (track.iter), the edges to other
    assert lay["track.init"]["idle_ms"] == pytest.approx(11e-6)
    assert lay["track.mask"]["idle_ms"] == pytest.approx(16e-6)
    assert lay["track.iter"]["idle_ms"] == pytest.approx(41e-6)
    assert sum(p["idle_ms"] for p in lay.values()) == \
        pytest.approx(j["idle_ms"])
    m = spans_tracking.metrics(j)
    assert m["pnp_ms_per_frame.nonrigid"] == pytest.approx(20e-6)
    assert m["rigid_mask_dev_ms_per_frame.nonrigid"] == pytest.approx(4e-6)
    assert m["track_dev_ms_per_frame.nonrigid"] == pytest.approx(28e-6)
    assert m["track_idle_ms_per_frame.nonrigid"] == pytest.approx(68e-6)


def _broken(monkeypatch, fault):
    from freesurgs_tpu_torch.models import pnp
    from freesurgs_tpu_torch.models import pose as posemod
    if fault == "pnp_skipped":
        monkeypatch.setattr(posemod, "pnp_pose_init",
                            lambda poses, t, *a, **kw:
                            posemod.const_velocity_init(poses, t))
    elif fault == "pnp_refit_on_all":
        real = pnp.solve_pnp_ransac

        def refit(obj, img, K, **kw):
            res = real(obj, img, K, **kw)
            R, t = pnp.gauss_newton(res.R, res.t, obj.double(), img.double(),
                                    K.double())
            return pnp.PnPResult(res.ok, R, t, res.inliers)
        monkeypatch.setattr(posemod, "solve_pnp_ransac", refit)


@pytest.mark.parametrize("fault", ["pnp_skipped", "pnp_refit_on_all"])
def test_broken_pnp_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    _broken(monkeypatch, fault)
    out = _run(tmp_path, capsys)
    assert not out["correct"]
    assert not out["check"]["pnp_pose_gap"]["value"] <= \
        out["check"]["pnp_pose_gap"]["limit"]


@pytest.mark.card
def test_control_and_faults_fail_the_limits_on_the_card(tmp_path):
    """At a size a test run holds, the program passes the committed
    limits, and the reference put in its place in TF32, or with a planted
    fault, fails. Not ``pnp_no_ransac``: at 256x320 its refit over all
    matches moves the pose by less than ``pnp_pose_gap``'s limit (it
    fails it at the cell's own size, PERF.md §6, and at 48x64 in
    ``tests/test_torch_nonrigid_pnp.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    root, here = _root(tmp_path, h=256, w=320)
    limits = json.loads((tiny.PERFBENCH / "workloads" / f"{CELL}.json"
                         ).read_text())["limits"]
    stage = run.load_stage({"stage": "progressive_nonrigid"})
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r in control.readings(CELL, [2 ** 31 + 61, 2 ** 31 + 62],
                                  device="cuda", root=root, here=here,
                                  log=lambda m: None):
            assert check.judge(r["program"], limits), r
            for fault in ("control", "unchanged",
                          *(f for f in stage.FAULTS if f != "pnp_no_ransac")):
                assert not check.judge(r[fault], limits), (
                    fault, {k: v for k, v in r[fault].items() if v})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
