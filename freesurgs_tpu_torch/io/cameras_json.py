"""cameras.json export for external 3DGS viewers
(port of ``freesurgs_tpu/io/cameras_json.py``).

One record per frame: id, image name, size, camera-to-world position and
rotation, focal lengths, in the format the graphdeco SIBR / web viewers
read.
"""

from __future__ import annotations

import json

import torch

from ..core.camera import Camera
from ..core.transforms import invert_se3


def cameras_to_json(w2cs, cam: Camera, names=None) -> list[dict]:
    """``w2cs``: (N, 4, 4) world-to-camera matrices (numpy or tensor)."""
    c2ws = invert_se3(torch.as_tensor(w2cs).detach().cpu()).numpy()
    return [{"id": i,
             "img_name": names[i] if names else f"frame_{i:06d}",
             "width": cam.width, "height": cam.height,
             "position": c2w[:3, 3].tolist(),
             "rotation": c2w[:3, :3].tolist(),
             "fx": cam.fx, "fy": cam.fy}
            for i, c2w in enumerate(c2ws)]


def save_cameras_json(path: str, w2cs, cam: Camera, names=None):
    with open(path, "w") as f:
        json.dump(cameras_to_json(w2cs, cam, names), f)
