"""SCARED-format sequence loader (port of ``freesurgs_tpu/data/scared.py``).

Directory layout:

  <root>/input/<scene>_<data>_frame_<id>.png        RGB frames
  <root>/poses/<scene>_<data>/frame_<id>.json       {"camera-pose": 4x4,
                                                     "camera-calibration":
                                                     {"KL": 3x3}}
  <root>/flow/flow_fw_<name>.npz / flow_bw_<name>.npz  flow ('pred')
  <root>/monodep/depth_<name>.npz                      mono disparity ('pred')

The JAX loader's preprocessing, kept: depth = 1 / disparity, per frame
min-max normalized into [0.5, 1.5] (or kept, ``depth_prior="metric"``);
intrinsics rescaled from the 1280x1024 calibration to the image size; test
frames ``sample_rate // 2 :: sample_rate``; subsequence boundaries by the
<data> index. Frames decode with the port's own PNG codec (``io/png.py``),
so the loader needs no PIL; JPEG frames raise ``NotImplementedError``.

The FSC1 cache (``io/native.py``) is shared with the JAX package: the same
``.fsio_cache_<tag>.fsc`` name and bytes, so either package reads a cache
the other wrote.
"""

from __future__ import annotations

import glob
import json
import os
from typing import NamedTuple

import numpy as np

from ..core.camera import Camera
from ..io import native
from ..io.png import read_png, write_png

CALIB_W, CALIB_H = 1280, 1024


class VideoSequence(NamedTuple):
    cam: Camera
    colors: np.ndarray        # (T, 3, H, W) float32 [0, 1]
    flows_fw: np.ndarray      # (T-1, 2, H, W)
    flows_bw: np.ndarray      # (T-1, 2, H, W)
    monodeps: np.ndarray      # (T, H, W) depth prior
    gt_poses: dict            # data_ind -> (Tk, 4, 4) float64
    boundaries: list          # subsequence frame boundaries, len = #seqs+1
    i_train: np.ndarray
    i_test: np.ndarray
    image_names: list

    @property
    def num_frames(self) -> int:
        return self.colors.shape[0]


def cache_path(root: str, frame_start: int, frame_end: int,
               sample_rate: int, depth_prior: str) -> str:
    """The FSC1 cache file of one load's arguments (the JAX name)."""
    tag = f"{frame_start}_{frame_end}_{sample_rate}"
    if depth_prior != "normalized":
        tag += f"_{depth_prior}"
    return os.path.join(root, f".fsio_cache_{tag}.fsc")


def load_scared(root: str, frame_start: int = 0, frame_end: int = -1,
                sample_rate: int = 8, cache: str | None = "auto",
                depth_prior: str = "normalized") -> VideoSequence:
    """Load a SCARED-layout sequence.

    cache: "auto" reads ``<root>/.fsio_cache_<tag>.fsc`` when it exists (a
    stale or corrupt one is removed and rebuilt) and otherwise writes it
    after a raw load (a read-only directory runs uncached); None always
    loads the raw files.

    depth_prior: "normalized" remaps each frame's 1 / disparity into
    [0.5, 1.5] (monocular networks with arbitrary per-frame scale);
    "metric" keeps 1 / disparity (stereo, ToF, synthetic ground truth).
    """
    if depth_prior not in ("normalized", "metric"):
        raise ValueError(f"depth_prior={depth_prior!r}: 'normalized' or "
                         "'metric'")
    if cache == "auto":
        cpath = cache_path(root, frame_start, frame_end, sample_rate,
                           depth_prior)
        if os.path.exists(cpath):
            try:
                return native.read_sequence_cache(cpath)
            except (OSError, KeyError, ValueError):
                os.remove(cpath)              # stale / corrupt: rebuild
        seq = load_scared(root, frame_start, frame_end, sample_rate,
                          cache=None, depth_prior=depth_prior)
        tmp = f"{cpath}.{os.getpid()}.tmp"
        try:
            native.write_sequence_cache(tmp, seq)
            os.replace(tmp, cpath)
        except OSError:
            if os.path.exists(tmp):           # read-only or full: uncached
                os.remove(tmp)
        return seq

    rgb_paths = sorted(
        glob.glob(os.path.join(root, "input", "*.png"))
        + glob.glob(os.path.join(root, "input", "*.jpeg"))
        + glob.glob(os.path.join(root, "input", "*.jpg")))
    if not rgb_paths:
        raise FileNotFoundError(f"no frames under {root}/input")
    if frame_end != -1:
        rgb_paths = rgb_paths[frame_start:frame_end]
    for p in rgb_paths:
        if not p.endswith(".png"):
            raise NotImplementedError(
                f"{p}: the port decodes PNG frames only (io/png.py); "
                "convert JPEG frames to PNG first")

    colors, flows_fw, flows_bw, monodeps = [], [], [], []
    gt_poses: dict[str, list] = {}
    intrinsic = None
    n = len(rgb_paths)
    for i, p in enumerate(rgb_paths):
        name = os.path.basename(p)
        parts = name.split("_")
        scene_ind, data_ind = parts[0], parts[1]
        img_name = parts[3].split(".")[0]
        stem = name.split(".")[0]

        pose_path = os.path.join(root, "poses", f"{scene_ind}_{data_ind}",
                                 f"frame_{img_name}.json")
        with open(pose_path) as f:
            meta = json.load(f)
        gt_poses.setdefault(data_ind, []).append(
            np.array(meta["camera-pose"], np.float64))
        intrinsic = np.array(meta["camera-calibration"]["KL"], np.float64)

        img = read_png(p).astype(np.float32) / 255.0
        colors.append(img.transpose(2, 0, 1))

        if i < n - 1:
            flows_fw.append(np.load(
                os.path.join(root, f"flow/flow_fw_{stem}.npz"))["pred"])
            flows_bw.append(np.load(
                os.path.join(root, f"flow/flow_bw_{stem}.npz"))["pred"])

        disp = np.load(os.path.join(root,
                                    f"monodep/depth_{stem}.npz"))["pred"]
        dep = 1.0 / np.clip(disp, 1e-6, 1e6)
        if depth_prior == "normalized":
            dep = (dep - dep.min()) / max(dep.max() - dep.min(),
                                          1e-12) + 0.5
        monodeps.append(dep.astype(np.float32))

    H, W = colors[0].shape[1:]
    intrinsic = intrinsic.copy()
    intrinsic[0, :] *= W / CALIB_W
    intrinsic[1, :] *= H / CALIB_H
    cam = Camera.from_K(intrinsic, height=H, width=W)

    all_idx = np.arange(n)
    i_test = all_idx[sample_rate // 2::sample_rate]
    test = set(i_test.tolist())
    i_train = np.array([i for i in all_idx if i not in test])

    boundaries = [0]
    for key in gt_poses:
        gt_poses[key] = np.stack(gt_poses[key])
        boundaries.append(boundaries[-1] + len(gt_poses[key]))

    flows_fw = (np.stack(flows_fw) if flows_fw
                else np.zeros((0, 2, H, W), np.float32))
    flows_bw = (np.stack(flows_bw) if flows_bw
                else np.zeros((0, 2, H, W), np.float32))
    return VideoSequence(
        cam=cam, colors=np.stack(colors).astype(np.float32),
        flows_fw=flows_fw.astype(np.float32),
        flows_bw=flows_bw.astype(np.float32),
        monodeps=np.stack(monodeps), gt_poses=gt_poses,
        boundaries=boundaries, i_train=i_train, i_test=i_test,
        image_names=[os.path.basename(p) for p in rgb_paths])


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def frame_uint8(color) -> np.ndarray:
    """(H, W, 3) uint8 of a (3, H, W) [0, 1] frame (numpy or tensor), as
    the fixture writer stores it: x * 255 truncated, as JAX's writer."""
    return (_numpy(color).transpose(1, 2, 0) * 255).astype(np.uint8)


def save_synthetic_as_scared(scene, root: str, scene_ind: str = "d1",
                             data_ind: str = "k0"):
    """Write a synthetic scene (``data/synthetic.make_scene``) in the
    SCARED layout: the JAX writer's files, PNGs through ``io/png.py``."""
    for sub in ("input", "flow", "monodep"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    pose_dir = os.path.join(root, "poses", f"{scene_ind}_{data_ind}")
    os.makedirs(pose_dir, exist_ok=True)

    cam = scene.cam
    K = np.asarray(cam.intrinsic_matrix(), np.float64)
    K_calib = K.copy()
    K_calib[0, :] *= CALIB_W / cam.width
    K_calib[1, :] *= CALIB_H / cam.height

    T = scene.colors.shape[0]
    gt_w2c, flows = _numpy(scene.gt_w2c), _numpy(scene.flows_fw)
    for t in range(T):
        name = f"{scene_ind}_{data_ind}_frame_{t:06d}"
        write_png(os.path.join(root, "input", f"{name}.png"),
                  frame_uint8(scene.colors[t]))
        with open(os.path.join(pose_dir, f"frame_{t:06d}.json"), "w") as f:
            json.dump({"camera-pose": gt_w2c[t].tolist(),
                       "camera-calibration": {"KL": K_calib.tolist()}}, f)
        # disparity such that 1 / disp gives back the depth
        disp = 1.0 / np.maximum(_numpy(scene.depths[t]), 1e-6)
        np.savez(os.path.join(root, "monodep", f"depth_{name}.npz"),
                 pred=disp)
        if t < T - 1:
            np.savez(os.path.join(root, "flow", f"flow_fw_{name}.npz"),
                     pred=flows[t])
            np.savez(os.path.join(root, "flow", f"flow_bw_{name}.npz"),
                     pred=-flows[t])
