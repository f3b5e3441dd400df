"""The viewer's render paths (``viz/camera_path.py``, ``viz/viewer.py``),
``utils/profiling.py``, the camera's field of view and the Trainer's
viewer hook, against the JAX package's.

- ``interpolate_path`` / ``ellipse_orbit``: the JAX functions' poses
  within 1e-6 (float32 quaternion round trips in both packages);
- ``render_path``: frames (with and without the depth strip) within 2e-5
  of JAX ``render_path(impl="oracle")`` at 32x48 (the render parity gate),
  PNGs within 1 LSB (8-bit truncation of those frames);
- ``GSViewer`` on the stub viser server of tests/test_viewer_panels.py:
  each of its cases driven on both viewers, the panel values (sliders,
  status texts, keyframes within 1e-6, backgrounds and exported PNGs
  within 1 LSB) held against the JAX viewer's;
- the Trainer with a viewer: one report per progressive frame and per
  global chunk; without one, no ``StepTimer`` stop (so no host sync).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCamera
from freesurgs_tpu.core.camera import focal2fov as jfocal2fov
from freesurgs_tpu.core.transforms import build_w2c as jbuild_w2c
from freesurgs_tpu.models.gaussians import from_pointcloud
from freesurgs_tpu.utils.profiling import StepTimer as JStepTimer
from freesurgs_tpu.viz import camera_path as jpath
from freesurgs_tpu.viz.viewer import GSViewer as JViewer
from freesurgs_tpu_torch.convert import FIELD_KEYS, field_from_numpy
from freesurgs_tpu_torch.core.camera import Camera, focal2fov
from freesurgs_tpu_torch.data.synthetic import SceneSequence, make_scene
from freesurgs_tpu_torch.io.png import read_png
from freesurgs_tpu_torch.train import loop
from freesurgs_tpu_torch.train.steps import TrainConfig
from freesurgs_tpu_torch.utils import profiling
from freesurgs_tpu_torch.viz import camera_path as tpath
from freesurgs_tpu_torch.viz.viewer import GSViewer

from test_viewer_panels import _Server

PIX_TOL = 2e-5
POSE_TOL = 1e-6
H, W = 32, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny CPU tensors: the suite runs
    several workers on the machine's cores, where a pool of threads per
    worker spinning on small ops costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keyposes(n=5):
    """Keyposes whose segments take both slerp branches: small turns
    (linear blend) and a 40-degree one (true slerp)."""
    quats = [[1.0, 0.02 * i, -0.01 * i, 0.0] for i in range(n - 1)]
    quats.append([0.94, 0.0, 0.342, 0.0])
    poses = [np.asarray(jbuild_w2c(jnp.asarray(q),
                                   jnp.asarray([0.05 * i, 0.01 * i,
                                                0.02 * i])))
             for i, q in enumerate(quats)]
    return np.stack(poses)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.normal(size=(120, 3)).astype(np.float32) * 0.3
                      + np.array([0, 0, 2.0], np.float32))
    cols = jnp.asarray(rng.uniform(size=(120, 3)).astype(np.float32))
    jfield = from_pointcloud(pts, cols, 2.0, max_sh_degree=0, capacity=128)
    tfield = field_from_numpy({k: np.asarray(getattr(jfield, k))
                               for k in FIELD_KEYS}, device="cpu",
                              max_sh_degree=0)
    cam = dict(height=H, width=W, fx=40.0, fy=40.0, cx=24.0, cy=16.0)
    return jfield, tfield, JCamera(**cam), Camera(**cam)


def test_focal2fov_and_fov():
    c = dict(height=1024, width=1280, fx=1408.0, fy=1400.0, cx=640.0,
             cy=512.0)
    assert focal2fov(1408.0, 1280) == jfocal2fov(1408.0, 1280)
    assert Camera(**c).fov_x == JCamera(**c).fov_x
    assert Camera(**c).fov_y == JCamera(**c).fov_y


@pytest.mark.parametrize("fps", [1, 4])
def test_interpolate_path_matches_jax(fps):
    keys = keyposes()
    got, want = tpath.interpolate_path(keys, fps), jpath.interpolate_path(
        keys, fps)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((len(keys) - 1) * fps, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=POSE_TOL)


@pytest.mark.parametrize("n", [2, 6])
def test_ellipse_orbit_matches_jax(n):
    """n = 2: the rank-deficient fallback axes; n = 6: the SVD plane."""
    keys = keyposes(n)
    got, want = tpath.ellipse_orbit(keys, 12), jpath.ellipse_orbit(keys, 12)
    assert got.dtype == want.dtype and got.shape == want.shape == (12, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=POSE_TOL)


def decoded_close(a_path, b_path) -> int:
    """Largest 8-bit difference of two PNGs."""
    a = read_png(str(a_path)).astype(np.int16)
    b = read_png(str(b_path)).astype(np.int16)
    assert a.shape == b.shape
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("save_depth", [False, True])
def test_render_path_matches_jax(fields, tmp_path, save_depth):
    jfield, tfield, jcam, tcam = fields
    path = jpath.interpolate_path(keyposes(3), 2)
    want = jpath.render_path(jfield, path, jcam, str(tmp_path / "jax"),
                             impl="oracle", save_depth=save_depth)
    got = tpath.render_path(tfield, path, tcam, str(tmp_path / "torch"),
                            save_depth=save_depth)
    assert len(got) == len(want) == len(path)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=PIX_TOL)
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        f"path_{i:04d}.png" for i in range(len(path))]
    assert max(decoded_close(tmp_path / "torch" / n, tmp_path / "jax" / n)
               for n in names) <= 1
    if not save_depth:
        # a frame is the render at its pose, bitwise (no gradient graph)
        out = tpath.render_view(tfield, path[1], tcam)
        assert not out["render"].requires_grad
        assert np.array_equal(torch.clamp(out["render"], 0, 1).numpy(),
                              got[1])


def viewers(fields, tmp_path):
    """The JAX and the port's viewer, each on its own stub server."""
    jfield, tfield, jcam, tcam = fields
    poses = [np.eye(4, dtype=np.float32) for _ in range(5)]
    for i, p in enumerate(poses):
        p[0, 3] = 0.02 * i
    js, ts = _Server(), _Server()
    jv = JViewer(js, get_field=lambda: jfield, get_pose=lambda: jnp.eye(4),
                 cam=jcam, impl="oracle", get_frame_pose=lambda t: poses[t],
                 num_frames=5, export_dir=str(tmp_path / "jax"),
                 start_playback_thread=False)
    tv = GSViewer(ts, get_field=lambda: tfield, get_pose=lambda: torch.eye(4),
                  cam=tcam, get_frame_pose=lambda t: torch.from_numpy(
                      poses[t]), num_frames=5,
                  export_dir=str(tmp_path / "torch"),
                  start_playback_thread=False)
    return (js, jv), (ts, tv)


def same_backgrounds(jc, tc):
    assert len(jc.scene.backgrounds) == len(tc.scene.backgrounds)
    for a, b in zip(jc.scene.backgrounds, tc.scene.backgrounds):
        assert a.shape == b.shape == (H, W, 3) and b.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_viewer_playback_panel(fields, tmp_path):
    (js, jv), (ts, tv) = viewers(fields, tmp_path)
    clients = []
    for server, v in ((js, jv), (ts, tv)):
        client = server.connect()
        slider = server.gui.elems["frame"]
        slider.value = 3
        slider.click()
        server.gui.elems["Play/Pause playback"].click()
        assert v.playing
        for _ in range(3):
            v.playback_tick()
        server.gui.elems["Play/Pause playback"].click()
        assert not v.playing
        clients.append(client)
    assert ts.gui.elems["frame"].value == js.gui.elems["frame"].value == 1
    same_backgrounds(*clients)
    assert len(clients[1].scene.backgrounds) == 4


def test_viewer_keyframes_and_export(fields, tmp_path):
    (js, jv), (ts, tv) = viewers(fields, tmp_path)
    clients = []
    for server in (js, ts):
        client = server.connect()
        add = server.gui.elems["Add camera keyframe"]
        add.click()
        client.camera.position = np.array([0.3, 0.0, 0.0])
        add.click()
        server.gui.elems["Preview path"].click()
        server.gui.elems["Export path frames"].click()
        clients.append(client)
    assert len(tv._keyframes) == len(jv._keyframes) == 2
    for a, b in zip(jv._keyframes, tv._keyframes):
        np.testing.assert_allclose(b, a, rtol=0, atol=POSE_TOL)
    same_backgrounds(*clients)
    assert ts.gui.elems["keyframes"].value == \
        js.gui.elems["keyframes"].value == "exported 10 frames"
    names = sorted(os.listdir(tv.export_dir))
    assert names == sorted(os.listdir(jv.export_dir)) and len(names) == 10
    assert max(decoded_close(os.path.join(tv.export_dir, n),
                             os.path.join(jv.export_dir, n))
               for n in names) <= 1


def test_viewer_needs_two_keyframes(fields, tmp_path):
    (js, jv), (ts, tv) = viewers(fields, tmp_path)
    for server in (js, ts):
        server.connect()
        server.gui.elems["Add camera keyframe"].click()
        server.gui.elems["Preview path"].click()
        preview = server.gui.elems["keyframes"].value
        server.gui.elems["Export path frames"].click()
        assert server.gui.elems["keyframes"].value == preview
    assert ts.gui.elems["keyframes"].value == \
        js.gui.elems["keyframes"].value == "need >= 2 keyframes"
    assert not os.path.exists(tv.export_dir)


def test_viewer_pause_and_report(fields, tmp_path):
    (js, jv), (ts, tv) = viewers(fields, tmp_path)
    seen = []
    for server, v in ((js, jv), (ts, tv)):
        v.report(rays_per_sec=3.2e6, frame=2)
        a = v.status.value
        server.gui.elems["Pause/Resume"].click()
        b = v.status.value
        v.report(rays_per_sec=1.0e6, frame=3)    # ignored while paused
        c = v.status.value
        server.gui.elems["Pause/Resume"].click()
        v.report()
        seen.append((a, b, c, v.status.value, v.paused))
    assert seen[0] == seen[1] == ("frame 2 | 3.20 Mrays/s", "paused",
                                  "paused", "run", False)


def test_step_timer_and_hooks(tmp_path, monkeypatch):
    """StepTimer counts the JAX timer's rays and, on a CPU tensor, does not
    touch CUDA; trace writes a chrome trace with the spans recorded
    meanwhile on its clock."""
    def no_cuda(*a):
        raise AssertionError("synchronized on the CPU")
    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    t = profiling.StepTimer(H, W)
    assert t.rays_per_step == JStepTimer(H, W).rays_per_step == H * W * 3
    t.start()
    dt = t.stop(sync_on=torch.ones(2))
    assert dt >= 0 and t.rays_per_sec > 0
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("sum", request=5):
            torch.ones(8).sum()
    assert not profiling.SPANS.on
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    (sp,) = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::sum"]
    assert sp["name"] == "sum" and sp["args"]["request"] == 5 and ops
    # the span on the profiler's clock and its thread's row
    for op in ops:
        assert sp["tid"] == op["tid"] and sp["pid"] == op["pid"]
        assert sp["ts"] <= op["ts"]
        assert op["ts"] + op["dur"] <= sp["ts"] + sp["dur"]


class _Spy:
    def __init__(self):
        self.reports, self.waits = [], 0

    def report(self, rays_per_sec=None, frame=None):
        self.reports.append((rays_per_sec, frame))

    def wait_if_paused(self):
        self.waits += 1


@pytest.mark.parametrize("with_viewer", [True, False])
def test_trainer_viewer_hook(monkeypatch, with_viewer):
    """One report (and one pause check) per progressive frame and per
    global chunk, each after a StepTimer stop; with viewer=None no stop."""
    stops = []
    real_stop = loop.StepTimer.stop

    def stop(self, sync_on=None):
        stops.append(sync_on)
        return real_stop(self, sync_on)
    monkeypatch.setattr(loop.StepTimer, "stop", stop)
    sc = make_scene(num_frames=3, n_gaussians=60, height=H, width=W, seed=1,
                    device="cpu")
    cfg = TrainConfig(tracking_iters=1, mapping_iters=1,
                      first_frame_mapping_iters=1, tracking_gn_iters=0)
    spy = _Spy() if with_viewer else None
    tr = loop.Trainer(SceneSequence(sc), cfg, sh_degree_max=0,
                      capacity=4096, global_chunk=2, device="cpu",
                      validation_every=0, log_fn=lambda *a: None,
                      viewer=spy)
    tr.progressive_run()
    tr.global_run(5)
    if not with_viewer:
        assert stops == []
        return
    assert len(stops) == len(spy.reports) == spy.waits == 3 + 3
    assert all(torch.is_tensor(s) for s in stops)
    assert [f for _, f in spy.reports[:3]] == [0, 1, 2]
    assert all(np.isfinite(r) and r > 0 for r, _ in spy.reports)
    assert tr.cur_frame == spy.reports[-1][1]
