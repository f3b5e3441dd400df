"""Interactive web viewer (viser), gated on availability (port of
``freesurgs_tpu/viz/viewer.py``).

The reference's viser/nerfview viewer (``vis/viewer.py``, ``train.py:124-152
render_fn``): it renders the current Gaussian field from the client
camera, and the training loop cooperates through ``lock`` and the pause
flag (``train.py:227-231``). Beyond the free-orbit view it carries the
reference's two GUI panels:

- **Time / playback** (``vis/viewer.py:13-63`` + ``vis/playback_panel.py``):
  a frame slider over the sequence plus play/pause and fps controls;
  playback renders from the OPTIMIZED pose of the selected frame
  (``get_frame_pose``), driven by a daemon thread while playing.
- **Render tab** (``vis/render_panel.py:527+``): capture client camera
  keyframes, then preview / export a slerp + Catmull-Rom path through them
  (``viz/camera_path.py``).

The GUI wiring talks to the server through a small surface (``gui.add_*``,
``scene.set_background_image``), so a stub server object exercises every
callback headless. Without ``viser`` installed, ``GSViewer.create``
returns None and training runs headless.

Every render is one forward launch of the compositing kernel, with no
autograd graph, under ``lock``. The launch counters of
``ops/raster_cuda.py`` are process-wide: renders made from the server's
threads count into whatever path is being counted at the time. The field
is read through ``get_field``: the Trainer replaces its tensors rather
than updating them in place, so a render sees one consistent snapshot.
"""

from __future__ import annotations

import importlib
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..core.camera import Camera
from ..core.transforms import quat_to_rotmat
from .camera_path import interpolate_path, render_path, render_view


def viser_available() -> bool:
    try:
        importlib.import_module("viser")
    except ImportError:
        return False
    return True


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x)


class GSViewer:
    """Training-time viewer: free orbit, playback panel, render tab."""

    def __init__(self, server, get_field, get_pose, cam: Camera,
                 max_instances: int = 0, damping: float = 0.1,
                 get_frame_pose: Callable[[int], np.ndarray] | None = None,
                 num_frames: int = 0, export_dir: str | None = None,
                 start_playback_thread: bool = True):
        self.server = server
        self.get_field = get_field
        self.get_pose = get_pose
        self.cam = cam
        self.max_instances = max_instances
        self.damping = damping  # the reference dampens mouse deltas x0.1
        self.get_frame_pose = get_frame_pose
        self.num_frames = num_frames
        self.export_dir = export_dir
        self.lock = threading.Lock()
        self.paused = False
        self._init_c2w = None
        self._clients: list = []
        self._keyframes: list[np.ndarray] = []   # render-tab key poses

        with server.gui.add_folder("Training"):
            pause_btn = server.gui.add_button("Pause/Resume")
            self.status = server.gui.add_text("status", initial_value="run")

        @pause_btn.on_click
        def _(_):
            self.paused = not self.paused
            self.status.value = "paused" if self.paused else "run"

        # ---- Time / playback panel (reference vis/playback_panel.py)
        self.playing = False
        if get_frame_pose is not None and num_frames > 0:
            with server.gui.add_folder("Time"):
                self.frame_slider = server.gui.add_slider(
                    "frame", min=0, max=num_frames - 1, step=1,
                    initial_value=0)
                play_btn = server.gui.add_button("Play/Pause playback")
                self.fps_slider = server.gui.add_slider(
                    "fps", min=1, max=30, step=1, initial_value=10)

            @self.frame_slider.on_update
            def _(_):
                self.render_frame_view(int(self.frame_slider.value))

            @play_btn.on_click
            def _(_):
                self.playing = not self.playing

            if start_playback_thread:
                threading.Thread(target=self._playback_loop,
                                 daemon=True).start()
        else:
            self.frame_slider = None
            self.fps_slider = None

        # ---- Render tab (camera-path capture; reference render_panel)
        with server.gui.add_folder("Render"):
            add_kf = server.gui.add_button("Add camera keyframe")
            clear_kf = server.gui.add_button("Clear keyframes")
            preview = server.gui.add_button("Preview path")
            export = server.gui.add_button("Export path frames")
            self.kf_status = server.gui.add_text("keyframes",
                                                 initial_value="0")

        @add_kf.on_click
        def _(event):
            client = getattr(event, "client", None) or self._any_client()
            if client is not None:
                self._keyframes.append(
                    self._client_w2c(client) @ _numpy(self.get_pose()))
                self.kf_status.value = str(len(self._keyframes))

        @clear_kf.on_click
        def _(_):
            self._keyframes.clear()
            self.kf_status.value = "0"

        @preview.on_click
        def _(_):
            self.preview_path()

        @export.on_click
        def _(_):
            self.export_path()

        server.scene.add_camera_frustum("/camera", fov=cam.fov_y,
                                        aspect=cam.width / cam.height,
                                        scale=0.05)

        @server.on_client_connect
        def _(client):
            self._clients.append(client)

            @client.camera.on_update
            def _(_):
                self.update_render(client)

    @classmethod
    def create(cls, port: int, *args, **kw):
        if not viser_available():
            return None
        import viser
        server = viser.ViserServer(port=port, verbose=False)
        return cls(server, *args, **kw)

    # ------------------------------------------------------------ clients

    def _any_client(self):
        return self._clients[-1] if self._clients else None

    def _client_w2c(self, client) -> np.ndarray:
        """Dampened relative pose from the client camera (reference
        ``render_fn``, ``train.py:139-148``), (4, 4) float32."""
        try:
            import viser.transforms as vtf
            R = vtf.SO3(np.asarray(client.camera.wxyz)).as_matrix()
        except ImportError:   # stub server path
            R = quat_to_rotmat(torch.as_tensor(
                np.asarray(client.camera.wxyz, np.float32))).numpy()
        t = np.asarray(client.camera.position)
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        if self._init_c2w is None:
            self._init_c2w = c2w.copy()
        delta = np.linalg.inv(self._init_c2w) @ c2w
        w2c = np.eye(4)
        w2c[:3, :3] = delta[:3, :3].T
        w2c[:3, 3] = -self.damping * (delta[:3, :3].T @ delta[:3, 3])
        return w2c.astype(np.float32)

    # ------------------------------------------------------------- render

    def _render_w2c(self, w2c) -> np.ndarray:
        out = render_view(self.get_field(), w2c, self.cam,
                          max_instances=self.max_instances)
        return torch.clamp(out["render"], 0, 1).cpu().numpy()

    def _show(self, img: np.ndarray, client=None):
        target = client if client is not None else self._any_client()
        if target is not None:
            target.scene.set_background_image(
                (np.transpose(img, (1, 2, 0)) * 255).astype(np.uint8))

    def update_render(self, client):
        with self.lock:
            w2c = self._client_w2c(client) @ _numpy(self.get_pose())
            img = self._render_w2c(w2c)
        self._show(img, client)

    def render_frame_view(self, t: int):
        """Playback: render from the optimized pose of frame ``t``."""
        if self.get_frame_pose is None:
            return
        with self.lock:
            img = self._render_w2c(self.get_frame_pose(int(t)))
        self._show(img)

    def _playback_loop(self):
        while True:
            if self.playing and self.frame_slider is not None:
                self.playback_tick()
                time.sleep(1.0 / max(float(self.fps_slider.value), 1e-3))
            else:
                time.sleep(0.1)

    def playback_tick(self):
        """Advance the time slider one frame (wrapping) and render it."""
        nxt = (int(self.frame_slider.value) + 1) % self.num_frames
        self.frame_slider.value = nxt
        self.render_frame_view(nxt)

    # --------------------------------------------------------- render tab

    def path_w2cs(self, frames_per_segment: int = 10) -> np.ndarray | None:
        if len(self._keyframes) < 2:
            return None
        return interpolate_path(np.stack(self._keyframes),
                                frames_per_segment)

    def preview_path(self, frames_per_segment: int = 4):
        path = self.path_w2cs(frames_per_segment)
        if path is None:
            self.kf_status.value = "need >= 2 keyframes"
            return
        for w2c in path:
            with self.lock:
                self._show(self._render_w2c(w2c))

    def export_path(self, frames_per_segment: int = 10):
        path = self.path_w2cs(frames_per_segment)
        if path is None or self.export_dir is None:
            self.kf_status.value = ("need >= 2 keyframes"
                                    if path is None else "no export dir")
            return
        with self.lock:
            render_path(self.get_field(), path, self.cam, self.export_dir,
                        max_instances=self.max_instances)
        self.kf_status.value = f"exported {len(path)} frames"

    # ----------------------------------------------------- training hooks

    def report(self, rays_per_sec: float | None = None,
               frame: int | None = None):
        """Training-loop heartbeat (the reference reports rays/s to the
        viewer each step, ``train.py:281-285``); renders nothing."""
        if self.paused:
            return
        bits = []
        if frame is not None:
            bits.append(f"frame {frame}")
        if rays_per_sec is not None and rays_per_sec == rays_per_sec:
            bits.append(f"{rays_per_sec / 1e6:.2f} Mrays/s")
        self.status.value = " | ".join(bits) or "run"

    def wait_if_paused(self):
        while self.paused:
            time.sleep(0.1)
