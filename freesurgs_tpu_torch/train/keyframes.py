"""Keyframe selection by viewpoint overlap
(port of ``freesurgs_tpu/train/keyframes.py``).

Sample pixels with valid depth from the current frame, back-project them,
reproject into each candidate keyframe, score each candidate by the share
of points that land inside the image less a 20 px edge with positive
depth, and pick at random among the candidates with positive overlap.
Random draws come from a CPU ``torch.Generator`` (JAX splits keys), so
only the draw-independent cases agree with the JAX package number for
number. Everything stays on the device: no host read.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera, backproject, project
from ..core.transforms import invert_se3


def _gumbel(n: int, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, generator=generator).to(device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))


def keyframe_overlap_scores(cur_depth: torch.Tensor, cur_w2c: torch.Tensor,
                            kf_w2cs: torch.Tensor, cam: Camera,
                            generator: torch.Generator, pixels: int = 1600,
                            edge: int = 20) -> torch.Tensor:
    """Share of sampled current-frame points visible in each keyframe.

    cur_depth (H, W); kf_w2cs (K, 4, 4). Returns (K,) scores in [0, 1].
    ``pixels`` pixels are drawn without replacement by Gumbel top-k over
    the validity mask (depth > 0), as in JAX: with fewer valid pixels the
    draw takes invalid ones too, whose zero depth back-projects to the
    camera centre, and they count in the score.
    """
    H, W = cam.height, cam.width
    valid = cur_depth.reshape(-1) > 0
    logits = torch.where(valid, 0.0, float("-inf"))
    g = _gumbel(logits.shape[0], generator, cur_depth.device)
    idx = torch.topk(logits + g, pixels).indices
    pts_w = backproject(cur_depth, cam, invert_se3(cur_w2c))[idx]
    pc = pts_w @ kf_w2cs[:, :3, :3].transpose(1, 2) + kf_w2cs[:, None, :3, 3]
    uv, z = project(pc, cam)                         # (K, P, 2), (K, P)
    ok = ((uv[..., 0] > edge) & (uv[..., 0] < W - edge)
          & (uv[..., 1] > edge) & (uv[..., 1] < H - edge) & (z > 0))
    return ok.to(torch.float32).mean(dim=1)


def select_overlap_keyframes(scores: torch.Tensor,
                             generator: torch.Generator,
                             k: int) -> torch.Tensor:
    """Random k among the positions with positive overlap. Returns (k,)
    indices into ``scores``; with fewer than k positive the last one
    repeats.

    The ranking is JAX's: positives in random order, then the others in
    descending position (the reversed stable argsort of -inf ties), so
    with no positive score every index is the LAST position.
    """
    pos = scores > 0
    g = _gumbel(scores.shape[0], generator, scores.device)
    key = torch.where(pos, g, float("-inf"))
    ranked = torch.argsort(key, stable=True).flip(0)
    n_pos = torch.clamp_min(pos.sum(), 1)
    take = torch.minimum(torch.arange(k, device=scores.device), n_pos - 1)
    return ranked[take]
