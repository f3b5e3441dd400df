"""The progressive stage's cell on the CPU at a tiny size: the reference's
tracking against the program's, the stage module's frame path against
``Trainer.progressive_run``, a run that comes out correct and reports its
own end-to-end metrics, and faults, planted in the program or in the
reference put in its place, that come out not correct."""

import json
import time

import pytest
import torch

from perfbench import check, control, run
from perfbench.reference import mapping as M
from perfbench.reference import render as R
from perfbench.reference import tracking as T
from perfbench.tests import tiny

CELL = "cfg34.progressive"
SEED = 2 ** 31 + 11


def _root(tmp_path, h=48, w=64, **train):
    """The tiny benchmark, its progressive configuration with short tracking
    and mapping, and a window of frames 2-5 (test frame 4) before the
    checked frame 6."""
    root, here = tiny.make_root(tmp_path, h=h, w=w)
    sp = root / "perfbench" / "configs" / "scared_cfg34_sfmfree.json"
    spec = json.loads(sp.read_text())
    spec["train"].update({"tracking_iters": 6, "mapping_iters": 6, **train})
    sp.write_text(json.dumps(spec))
    tp = here / "traffic" / "progressive.json"
    traffic = json.loads(tp.read_text())
    traffic.update(window_frames=[2, 5], trace_frames=[2, 3], check_frame=6)
    tp.write_text(json.dumps(traffic))
    return root, here


def _run(tmp_path, capsys, cell=CELL, trace=0, root=None):
    root, here = root or _root(tmp_path)
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "0.1", "--trace", str(trace)], device="cpu", root=root,
                  here=here, t_start=time.time())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _stage():
    return run.load_stage({"stage": "progressive_run"})


def _trainer(tmp_path, **train):
    """A tiny Trainer after frame 0 and frames 1-2, as the harness builds it,
    with the sequence and the train frames."""
    root, here = _root(tmp_path, **train)
    _, _, spec, traffic, _ = run.load_cell(CELL, root, here)
    traffic = dict(traffic, warmup_frames=[1, 2], window_frames=[3, 5])
    trainer, i_train, inputs = _stage()._setup(spec, traffic, SEED, "cpu",
                                               lambda m: None)
    return trainer, inputs["seq"], i_train


def test_reference_tracking_matches_the_program(tmp_path):
    from freesurgs_tpu_torch.models import pose as posemod
    from freesurgs_tpu_torch.train.flow_pnp import flow_pnp_refine
    from freesurgs_tpu_torch.train.steps import tracking_loop
    trainer, seq, _ = _trainer(tmp_path, tracking_iters=4)
    t, cam, cfg = 3, seq.cam, trainer.cfg
    poses = trainer.poses
    q1, t1 = poses.quats[t - 1], poses.trans[t - 1]
    q2, t2 = poses.quats[t - 2], poses.trans[t - 2]
    prev_w2c = T.w2c(q1, t1)
    prev_depth = trainer.state.pred_depths[t - 1]

    mask = trainer._rigid_mask(t) > 0
    ref_mask = T.rigidity_mask(T.w2c(q2, t2), prev_w2c, seq.flows_fw[t - 2],
                               cam)
    assert float((mask != ref_mask).float().mean()) <= 1e-3

    init = posemod.const_velocity_init(poses, t)
    qi, ti = T.const_velocity(q1, t1, q2, t2)
    assert torch.allclose(init.quats[t], qi, atol=1e-7)
    assert torch.allclose(init.trans[t], ti, atol=1e-7)
    q_gn, t_gn, _ = flow_pnp_refine(
        init.quats[t], init.trans[t], prev_depth,
        poses.w2c(t - 1), trainer.flows_fw[t - 1], trainer.cam,
        rigid_mask=mask.float(), iters=8)
    R_ref, t_ref = T.gauss_newton(qi, ti, prev_depth, prev_w2c,
                                  seq.flows_fw[t - 1], cam, ref_mask)
    gap = check._pose_gap({"R": R.quat_rotmat(q_gn), "t": t_gn},
                          {"R": R_ref, "t": t_ref},
                          {"R": R.quat_rotmat(qi), "t": ti})
    assert gap <= 1e-3

    cap = _stage()._FrameCapture(3)
    with cap:
        tracking_loop(trainer.field, q_gn, t_gn, trainer.colors[t],
                      prev_depth, poses.w2c(t - 1), trainer.flows_fw[t - 1],
                      mask.float(), trainer.cam,
                      cfg._replace(tracking_gn_iters=0),
                      sh_degree=trainer.active_sh_degree)
    calls = cap.calls["track"]
    field = trainer.field
    params = {k: getattr(field, k).detach() for k in M.LEAVES}
    ref = T.track_at(
        params, field.active, [c["inputs"] for c in calls[:3]], cam,
        trainer.active_sh_degree, seq.colors[t], prev_depth, prev_w2c,
        seq.flows_fw[t - 1], ref_mask, cfg._asdict())
    for a, b in zip([c["loss"] for c in calls[:3]], ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for got, want in zip(calls[0]["grads"], (ref["grad1"]["q"],
                                             ref["grad1"]["t"])):
        assert torch.allclose(got, want, rtol=1e-4,
                              atol=1e-5 * float(want.norm()))
    # the pose after 3 steps: Adam over the program's own gradients
    kept = T.replay_tracking(q_gn, t_gn, [c["grads"] for c in calls[:3]], 4)
    q4, t4 = calls[3]["inputs"]
    assert torch.allclose(q4, kept["q"], atol=1e-7)
    assert torch.allclose(t4, kept["t"], atol=1e-7)


def _state_tensors(trainer):
    st = trainer.state
    out = {k: getattr(st.field, k) for k in M.LEAVES}
    out.update({"active": st.field.active, "pred_depths": st.pred_depths,
                "pred_colors": st.pred_colors, "quats": trainer.poses.quats,
                "trans": trainer.poses.trans})
    out.update({"mu_" + k: v for k, v in st.opt.mu.items()})
    return out


def _rows(history):
    return [{k: (v.tolist() if torch.is_tensor(v) else v)
             for k, v in r.items() if k != "seconds"} for r in history]


def _assert_same(a, b):
    assert _rows(a.history) == _rows(b.history)
    sa, sb = _state_tensors(a), _state_tensors(b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.keyframes == b.keyframes and \
        a.state.iteration == b.state.iteration


def test_frame_path_is_progressive_run(tmp_path):
    from freesurgs_tpu_torch.train.loop import Trainer
    from freesurgs_tpu_torch.train.steps import TrainConfig
    root, here = _root(tmp_path, tracking_iters=4, mapping_iters=4)
    _, _, spec, _, _ = run.load_cell(CELL, root, here)
    from perfbench import scene
    seq = scene.make_sequence(SEED, spec, "cpu")
    import types
    from freesurgs_tpu_torch.core.camera import Camera
    pseq = types.SimpleNamespace(
        cam=Camera.from_K(seq.K, height=seq.height, width=seq.width),
        colors=seq.colors, monodeps=seq.monodeps, flows_fw=seq.flows_fw,
        i_train=seq.i_train, i_test=seq.i_test)

    def make():
        return Trainer(pseq, TrainConfig(**spec["train"]),
                       sh_degree_max=spec["sh_degree"],
                       init_mask_frac=spec["init_mask_frac"], seed=SEED,
                       log_fn=lambda m: None, validation_every=0,
                       device="cpu")

    a, b = make(), make()
    a.progressive_run()
    i_train = set(int(i) for i in seq.i_train)
    stage = _stage()
    for t in range(b.num_frames):
        stage.frame(b, t, i_train, time.time())
    _assert_same(a, b)


def test_passes_repeat_the_same_work(tmp_path):
    trainer, _, i_train = _trainer(tmp_path)
    stage = _stage()
    snap = stage.snapshot(trainer)
    for t in (3, 4, 5):
        stage.frame(trainer, t, i_train, time.time())
    first = (list(trainer.history), _state_tensors(trainer),
             list(trainer.keyframes))
    stage.restore(trainer, snap)
    for t in (3, 4, 5):
        stage.frame(trainer, t, i_train, time.time())
    assert _rows(first[0]) == _rows(trainer.history)
    assert first[2] == trainer.keyframes
    for k, v in _state_tensors(trainer).items():
        assert torch.equal(first[1][k], v), k


@pytest.mark.parametrize("cell,want", [
    (CELL, {"progressive_s_per_frame", "setup_s"}),
    ("cfg34.global", {"global_it_per_s", "setup_s"})])
def test_cell_is_correct_and_reports_its_metrics(tmp_path, capsys, cell,
                                                 want):
    out = _run(tmp_path, capsys, cell)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == want
    assert out["failed"] == 0
    if cell == CELL:
        assert out["attempted"] % 4 == 0 and out["attempted"] > 0
        assert {"gn_pose_gap", "mask_gap", "tr_pose_gap", "kept_gap"} <= \
            set(out["check"])


def test_traced_run_is_correct(tmp_path, capsys):
    out = _run(tmp_path, capsys, trace=1)
    assert out["correct"], out["check"]
    assert out["attempted"] == 2 and list(out)[-1] == "check"


def _broken(monkeypatch, fault):
    from freesurgs_tpu_torch.train import loop, losses, steps
    if fault == "tracking_unchanged":
        real = steps.tracking_loop

        def unchanged(field, quat0, trans0, *a, **kw):
            _, _, metrics = real(field, quat0, trans0, *a, **kw)
            return quat0, trans0, metrics
        monkeypatch.setattr(steps, "tracking_loop", unchanged)
        monkeypatch.setattr(loop, "tracking_loop", unchanged)
    elif fault == "mapping_unchanged":
        real = steps.mapping_chunk

        def unchanged(state, *a, **kw):
            _, aux = real(state, *a, **kw)
            return state, aux
        monkeypatch.setattr(steps, "mapping_chunk", unchanged)
        monkeypatch.setattr(loop, "mapping_chunk", unchanged)
    elif fault == "half_rows":
        real = losses.rgb_loss

        def half_rows(img, gt, mask=None, **kw):
            h = img.shape[1] // 2
            m = None if mask is None else mask[..., :h, :]
            return real(img[:, :h], gt[:, :h], mask=m, **kw)
        monkeypatch.setattr(losses, "rgb_loss", half_rows)
    elif fault == "gn_skipped":
        monkeypatch.setattr(steps, "flow_pnp_refine",
                            lambda q, t, *a, **kw: (q, t, None))
    elif fault == "mask_dropped":
        monkeypatch.setattr(loop.Trainer, "_rigid_mask",
                            lambda self, t: torch.ones(
                                self.cam.height, self.cam.width))


@pytest.mark.parametrize("fault,number", [
    ("tracking_unchanged", "tr_pose_gap"),
    ("mapping_unchanged", "kept_gap"),
    ("half_rows", "loss_gap"),
    ("gn_skipped", "gn_pose_gap"),
    ("mask_dropped", "mask_gap")])
def test_broken_timed_path_is_not_correct(tmp_path, capsys, monkeypatch,
                                          fault, number):
    _broken(monkeypatch, fault)
    out = _run(tmp_path, capsys)
    assert not out["correct"]
    # a number that is not finite fails its limit too
    assert not out["check"][number]["value"] <= \
        out["check"][number]["limit"]


def test_planted_faults_fail_the_limits(tmp_path):
    root, here = _root(tmp_path)
    limits = json.loads((here / "workloads" / f"{CELL}.json").read_text()
                        )["limits"]
    (r,) = control.readings(CELL, [SEED], device="cpu", root=root,
                            here=here, log=lambda m: None)
    assert check.judge(r["program"], limits), r["program"]
    for fault in ("unchanged", "half_rows", "grad_half", "gn_skip",
                  "mask_drop"):
        assert not check.judge(r[fault], limits), (fault, r[fault])
    assert r["grad_half"]["tr_grad1_gap"] == pytest.approx(0.5, rel=1e-3)
    assert r["gn_skip"]["gn_pose_gap"] == pytest.approx(1.0)


@pytest.mark.card
def test_control_and_faults_fail_the_limits_on_the_card(tmp_path):
    """As ``test_perfbench_control.py`` holds the global cells: at a size a
    test run holds, the program passes the committed limits, and the
    reference put in its place in TF32, or with a planted fault, fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    root, here = _root(tmp_path, h=256, w=320)
    limits = json.loads((tiny.PERFBENCH / "workloads" / f"{CELL}.json"
                         ).read_text())["limits"]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r in control.readings(CELL, [2 ** 31 + 31, 2 ** 31 + 32,
                                         2 ** 31 + 33], device="cuda",
                                  root=root, here=here, log=lambda m: None):
            assert check.judge(r["program"], limits), r
            for fault in ("control", "unchanged", *_stage().FAULTS):
                assert not check.judge(r[fault], limits), (fault, r)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
