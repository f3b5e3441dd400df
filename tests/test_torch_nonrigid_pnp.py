"""The non-rigid SfM-free job's cell (``nonrigid.progressive``) on the CPU at
a small size: the benchmark's non-rigid sequence (``perfbench/
scene_nonrigid.py``) against the port's ``make_nonrigid_scene``, the
program's PnP init against the plain reference (``perfbench/reference/
pnp.py``), the stage reading correct and its planted faults not, the
tracking spans and the PnP counter, and ``Trainer.progressive_frame``
bitwise the frame loop it came from.

Sizes: 64x80 and 600 Gaussians for the sequence and PnP; the stage at
48x64 with short tracking and mapping. The non-rigid motions are scaled
by 1280 / width so that they move as many pixels a frame as at 1280x1024:
at 80 px a sway of 0.02 moves ~1 px, inside RANSAC's 3 px inlier radius,
and no match would be an outlier.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from freesurgs_tpu_torch.core.camera import Camera
from freesurgs_tpu_torch.core.transforms import rotmat_to_quat
from freesurgs_tpu_torch.data.synthetic import (SceneSequence,
                                                make_nonrigid_scene)
from freesurgs_tpu_torch.models import pnp as pnp_mod
from freesurgs_tpu_torch.models import pose as posemod
from freesurgs_tpu_torch.models.pose import PoseTable
from freesurgs_tpu_torch.train import loop
from freesurgs_tpu_torch.train.steps import TrainConfig
from freesurgs_tpu_torch.utils import profiling as P
from perfbench import check, run, scene_nonrigid, spans_tracking
from perfbench.reference import pnp as ref_pnp
from perfbench.tests import tiny

CELL = "nonrigid.progressive"
CONFIG = "scared_cfg34_nonrigid_pnp"
H, W = 64, 80
SEED = 2 ** 31 + 41


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(h=H, w=W, frames=6, gaussians=600) -> dict:
    spec = json.loads((tiny.PERFBENCH / "configs" / f"{CONFIG}.json"
                       ).read_text())
    spec["image"] = {"height": h, "width": w}
    spec["data"]["frames"] = frames
    spec["scene"].update(gaussians=gaussians, frames_generated=frames,
                         scale_range=[0.02, 0.06])
    nr = spec["scene"]["nonrigid"]
    nr["patch_amp"] *= 1280 / w
    nr["spec_speed"] *= 1280 / w
    return spec


@pytest.fixture(scope="module")
def scenes():
    """The benchmark's sequence and the port's scene from one seed."""
    spec = _spec()
    nr = spec["scene"]["nonrigid"]
    seq = scene_nonrigid.make_sequence(SEED, spec, "cpu")
    port, aux = make_nonrigid_scene(
        num_frames=6, n_gaussians=600, height=H, width=W, seed=SEED,
        scale_range=(0.02, 0.06), patch_amp=nr["patch_amp"],
        spec_speed=nr["spec_speed"], device="cpu")
    return seq, port, aux


def test_sequence_matches_the_port_generator(scenes):
    seq, port, aux = scenes
    # colours: the benchmark's are 8-bit (x * 255 truncated, / 255), so at
    # most 1/255 below the port's float colours; the two renderers agree
    # to float32 rounding (1e-5)
    d = port.colors - seq.colors
    assert float(d.min()) > -1e-5 and float(d.max()) < 1 / 255 + 1e-5
    # flow: the same back-projection, displacement and projection in
    # float32, on depths that agree to float32 rounding; 1e-3 px
    assert torch.allclose(seq.flows_fw, port.flows_fw, rtol=0, atol=1e-3)
    # the ground truth: memberships over 0.3; a pixel whose membership
    # sits within rounding of 0.3 may differ (none at this seed)
    assert bool(aux["nonrigid_mask"].any())
    assert float((seq.nonrigid_mask != aux["nonrigid_mask"]).float()
                 .mean()) <= 1e-3
    # the depth prior is metric: the rendered depth through float32
    # disparity
    assert torch.allclose(seq.monodeps, port.depths, rtol=1e-5, atol=0)
    np.testing.assert_allclose(seq.gt_w2c, port.gt_w2c.double().numpy(),
                               atol=1e-6)


def _cam(seq) -> Camera:
    return Camera.from_K(seq.K, height=seq.height, width=seq.width)


def _pose_gap(w2c, ref, prev) -> float:
    return check._pose_gap({"R": w2c[:3, :3], "t": w2c[:3, 3]},
                           {"R": ref[:3, :3], "t": ref[:3, 3]},
                           {"R": prev[:3, :3], "t": prev[:3, 3]})


@pytest.mark.parametrize("t", [2, 3, 5])
def test_pnp_init_matches_the_reference(scenes, t):
    """Frame t from frame t-1's depth and the flow t-1 -> t at the true
    pose of t-1: the program's RANSAC PnP and the reference's draw the same
    matches and sets and pick a winner with the same inlier count; their
    poses agree to the program's float32 pose (1e-5 of a frame's motion),
    and the planted faults (constant velocity, no RANSAC) miss by more
    than a tenth of it."""
    seq, port, _ = scenes
    cam = _cam(seq)
    gt = torch.as_tensor(seq.gt_w2c, dtype=torch.float32)
    q = torch.stack([rotmat_to_quat(g[:3, :3]) for g in gt])
    poses = PoseTable(quats=q, trans=gt[:, :3, 3].clone())
    depth = port.depths[t - 1]
    pnp_mod.reset_pnp()
    out = posemod.pnp_pose_init(poses, t, seq.flows_fw[t - 1], depth,
                                poses.w2c(t - 1), cam, seed=SEED + t)
    counted = dict(pnp_mod.PNP)
    ref = ref_pnp.pose_init(poses.w2c(t - 1), seq.flows_fw[t - 1], depth,
                            seq.cam, SEED + t)
    assert ref["ok"] and counted["fallbacks"] == 0
    assert counted == {"calls": 1, "fallbacks": 0,
                       "matches": ref["matches"], "hypotheses": 100,
                       "inliers": ref["inliers"]}
    assert 1000 < ref["matches"] <= 4000
    prev = poses.w2c(t - 1).double()
    prog = out.w2c(t).double()
    assert _pose_gap(prog, ref["w2c"], prev) <= 1e-5
    no_ransac = ref_pnp.pose_init(poses.w2c(t - 1), seq.flows_fw[t - 1],
                                  depth, seq.cam, SEED + t, ransac=False)
    assert _pose_gap(no_ransac["w2c"], ref["w2c"], prev) >= 0.1
    cv = posemod.const_velocity_init(poses, t).w2c(t).double()
    assert _pose_gap(cv, ref["w2c"], prev) >= 0.1


def _root(tmp_path):
    """The tiny benchmark at 48x64 (Gauss-Newton keeps to pixels 20 px
    inside the image, so no smaller) with the non-rigid configuration,
    3 tracking and mapping steps a frame (2 checked), warm-up frame 1,
    window frame 2 and checked frame 3."""
    root, here = tiny.make_root(tmp_path)
    sp = root / "perfbench" / "configs" / f"{CONFIG}.json"
    spec = json.loads(sp.read_text())
    spec["scene"]["nonrigid"] = _spec(48, 64)["scene"]["nonrigid"]
    spec["train"].update(tracking_iters=3, mapping_iters=3)
    sp.write_text(json.dumps(spec))
    tp = here / "traffic" / "progressive_nonrigid.json"
    traffic = json.loads(tp.read_text())
    traffic.update(window_frames=[2, 2], trace_frames=[2, 2], check_frame=3,
                   check_tracking_steps=2, check_mapping_steps=2)
    tp.write_text(json.dumps(traffic))
    return root, here


FAULT_FAILS = {"pnp_skip": "pnp_pose_gap", "pnp_no_ransac": "pnp_pose_gap",
               "mask_drop": "mask_gap", "gn_skip": "gn_pose_gap",
               "half_rows": "loss_gap"}


def test_stage_is_correct_and_planted_faults_are_not(tmp_path):
    """The stage's checked frame against the reference from the program's
    state reads correct under the committed limits; the reference put in
    the program's place with each planted fault reads not correct, and
    reads higher than the program on the number the fault is planted for
    (at this size the mask cuts few pixels, so dropping it may fail the
    tracking numbers before ``mask_gap``)."""
    root, here = _root(tmp_path)
    _, _, spec, traffic, _ = run.load_cell(CELL, root, here)
    limits = json.loads((tiny.PERFBENCH / "workloads" / f"{CELL}.json"
                         ).read_text())["limits"]
    stage = run.load_stage(traffic, here)
    assert set(FAULT_FAILS) <= set(stage.FAULTS)
    trainer, inputs = stage.prepare(spec, traffic, SEED, "cpu",
                                    lambda m: None)
    del trainer
    ref = stage.check(inputs)
    prog = check.numbers(inputs["program"], ref)
    assert set(prog) == set(limits)
    assert check.judge(prog, limits), prog
    for fault, number in FAULT_FAILS.items():
        r = check.numbers(stage.check(inputs, **stage.FAULTS[fault]), ref)
        assert not check.judge(r, limits), (fault, r)
        assert r[number] > prog[number], (fault, r)


def _trainer(pose_init="pnp", frames=5):
    sc, _ = make_nonrigid_scene(num_frames=frames, n_gaussians=150,
                                height=32, width=48, seed=5,
                                patch_amp=0.5, spec_speed=0.5, device="cpu")
    return loop.Trainer(
        SceneSequence(sc, i_test=[4]),
        TrainConfig(tracking_iters=3, mapping_iters=2,
                    first_frame_mapping_iters=3),
        sh_degree_max=0, capacity=4096, pose_init=pose_init, seed=3,
        device="cpu", validation_every=0, log_fn=lambda *a: None)


def _rows(history):
    return [{k: (v.tolist() if torch.is_tensor(v) else v)
             for k, v in r.items() if k != "seconds"} for r in history]


def _loop_body(self, t, i_train, t0):
    """The body of ``progressive_run``'s frame loop before
    ``progressive_frame`` (without a viewer or panels), statement by
    statement."""
    t_frame = time.time()
    self.cur_frame = t
    metrics: dict = {}
    overflow = []
    if t > 0:
        metrics = self.track_frame(t)
        if "overflow" in metrics:
            overflow.append(metrics["overflow"])
    if t not in i_train and self.cache_test_frames:
        out = self.render_frame(t)
        overflow.append(out["overflow"])
        with torch.no_grad():
            self.state.pred_depths[t] = out["render_dep"].to(torch.bfloat16)
            self.state.pred_colors[t] = torch.clamp(
                out["render"], 0.0, 1.0).to(torch.bfloat16)
    if t in i_train:
        self._update_sh_degree()
        n_it = (self.cfg.first_frame_mapping_iters if t == 0
                else self.cfg.mapping_iters)
        aux = self._map_frame(t, n_it, two_views=(t > 0))
        self.keyframes.append(t)
        metrics.update({k: aux[k] for k in ("loss", "num_active")})
        terms = aux["loss_terms"]
        if terms is not None:
            metrics["rgb"], metrics["pear"], metrics["lp"] = \
                terms[0], terms[1], terms[2]
        metrics["inst"] = aux["num_instances_max"]
        overflow.append(aux["overflow_max"])
        metrics["densify_events"] = aux["densify_events"]
        metrics["opacity_resets"] = aux["opacity_resets"]
        self._maybe_grow()
        self._report_nonfinite(aux, f"frame {t}")
    if overflow:
        metrics["overflow"] = torch.stack(
            [o.to(torch.float32) for o in overflow]).max()
        self._warn_overflow(float(metrics["overflow"]), f"frame {t}")
    metrics["seconds"] = time.time() - t_frame
    row = {"stage": "progressive", "frame": t, **metrics}
    if t in i_train and aux["keyframe_views"] is not None:
        row["keyframe_views"] = aux["keyframe_views"].tolist()
    self.history.append(row)
    if t % 10 == 0:
        self.log_fn(f"[progressive {t}/{self.num_frames}] "
                    + " ".join(f"{k}={float(v):.4g}"
                               for k, v in metrics.items())
                    + f" ({time.time() - t0:.1f}s)")
        self._flush_history()


@pytest.fixture(scope="module")
def runs():
    """Two Trainers over one sequence: ``progressive_run`` with the spans
    on, and the frame loop's old body; a third, spans off."""
    out = {}
    a = _trainer()
    P.SPANS.start()
    try:
        a.progressive_run()
    finally:
        out["spans"] = P.SPANS.stop()
    b = _trainer()
    i_train = set(int(i) for i in b.seq.i_train)
    for t in range(b.num_frames):
        _loop_body(b, t, i_train, time.time())
    c = _trainer()
    c.progressive_run()
    out.update(run=a, body=b, off=c)
    return out


def _state(tr) -> dict:
    st = tr.state
    return {**{f"p.{k}": v for k, v in st.field.param_dict().items()},
            **{f"mu.{k}": v for k, v in st.opt.mu.items()},
            "active": st.field.active, "depths": st.pred_depths,
            "colors": st.pred_colors, "quats": tr.poses.quats,
            "trans": tr.poses.trans}


@pytest.mark.parametrize("other", ["body", "off"])
def test_progressive_frame_is_the_loop_body_bitwise(runs, other):
    """``progressive_run`` through ``progressive_frame`` (spans on) against
    the loop's old body and against itself with the spans off: poses, map,
    moments, caches and history rows bit for bit."""
    a, b = runs["run"], runs[other]
    assert _rows(a.history) == _rows(b.history)
    assert a.keyframes == b.keyframes
    sa, sb = _state(a), _state(b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_tracking_spans_nest_as_documented(runs):
    spans = runs["spans"]
    by_id = {s.id: s for s in spans}

    def parent(s):
        return by_id.get(s.parent)

    tracks = [s for s in spans if s.name == "track"]
    assert len(tracks) == runs["run"].num_frames - 1
    for name, n in (("track.init", 1), ("track.mask", 1), ("track.gn", 1),
                    ("track.iter", 3)):
        kids = [s for s in spans if s.name == name]
        assert len(kids) == n * len(tracks), name
        for s in kids:
            up = parent(s)
            assert up.name == "track" and up.start_ns <= s.start_ns and \
                s.end_ns <= up.end_ns, name
    for s in spans:
        if s.name in ("project", "raster", "bin") and parent(s) is not None \
                and parent(s).name.startswith("track"):
            up = s
            while up.name != "track.iter":
                up = parent(up)
                assert up is not None
    renders = [s for s in spans if s.name == "cache_render"]
    assert len(renders) == 1 and parent(renders[0]) is None
    # the join: PnP's wall ms per tracked frame, from the spans alone
    j = spans_tracking.join([], spans, P.SPANS.threads, P.SPANS.main_tid,
                            1.0, set())
    m = spans_tracking.metrics(j)
    inits = [s for s in spans if s.name == "track.init"]
    assert m == {"pnp_ms_per_frame.nonrigid": pytest.approx(sum(
        s.end_ns - s.start_ns for s in inits) * 1e-6 / len(tracks))}
    assert spans_tracking.metrics({"spans": {}}) == {}


def test_spans_off_record_nothing_and_cost_a_flag_test():
    P.SPANS.stop()
    assert P.span("track") is P._OFF and P.span("track.iter") is P._OFF
    tr = _trainer(frames=3)
    tr.progressive_run()
    assert P.SPANS.spans == []


class _HostReads(TorchFunctionMode):
    """The calls that read a tensor's value on the host."""
    READS = ("item", "tolist", "cpu", "numpy", "__int__", "__bool__",
             "__float__")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS:
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def test_pnp_counter_counts_and_reads_nothing_more(scenes):
    """Calls, fallbacks, matches, hypotheses and inliers; the solve's host
    reads are its own (the validity mask, the best count, the finiteness
    test) and the counter holds Python ints, so counting adds no
    synchronization."""
    seq, port, _ = scenes
    cam = _cam(seq)
    poses = posemod.identity_poses(6, "cpu")
    pnp_mod.reset_pnp()
    assert set(pnp_mod.PNP.values()) == {0}
    with _HostReads() as hr:
        posemod.pnp_pose_init(poses, 2, seq.flows_fw[1], port.depths[1],
                              poses.w2c(1), cam, seed=1)
    assert hr.reads == ["cpu", "numpy", "__int__", "__bool__"]
    first = dict(pnp_mod.PNP)
    assert first["calls"] == 1 and first["fallbacks"] == 0
    assert first["hypotheses"] == 100 and 6 <= first["inliers"] <= \
        first["matches"]
    # no depth: no match, a fallback, nothing solved
    posemod.pnp_pose_init(poses, 2, seq.flows_fw[1], torch.zeros(H, W),
                          poses.w2c(1), cam, seed=1)
    assert pnp_mod.PNP == dict(first, calls=2, fallbacks=1)
    assert all(type(v) is int for v in pnp_mod.PNP.values())
    pnp_mod.reset_pnp()
    assert set(pnp_mod.PNP.values()) == {0}


def test_reference_files_import_no_program():
    import ast
    for name in ("scene_nonrigid.py", "reference/pnp.py",
                 "spans_tracking.py"):
        tree = ast.parse((tiny.PERFBENCH / name).read_text())
        mods = {n.module or "" for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)} | {
            a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
        assert not any(m.split(".")[0] in ("jax", "freesurgs_tpu",
                                           "freesurgs_tpu_torch")
                       for m in mods), (name, mods)
