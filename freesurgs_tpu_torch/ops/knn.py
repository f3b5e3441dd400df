"""Mean squared distance to the 3 nearest neighbors, for scale init
(port of ``freesurgs_tpu/ops/knn.py``).

Exact chunked brute force: squared distances |x|^2 + |y|^2 - 2 x.y as one
matmul per column block, with a running top-4 merge to bound memory.
"""

from __future__ import annotations

import torch


def mean_sq_dist_3nn(pts: torch.Tensor, valid: torch.Tensor | None = None,
                     chunk: int = 2048) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the 3 nearest others.
    ``valid`` masks padding slots (they neither query nor serve; output 0)."""
    n = pts.shape[0]
    dev = pts.device
    npad = -(-max(n, 4) // chunk) * chunk
    big = 1e30
    p = torch.zeros(npad, 3, dtype=torch.float32, device=dev)
    p[:n] = pts.float()
    v = torch.zeros(npad, dtype=torch.bool, device=dev)
    v[:n] = True if valid is None else valid
    sq = torch.sum(p * p, dim=1)
    best = torch.full((npad, 4), big, device=dev)
    rows = torch.arange(npad, device=dev)[:, None]
    for j in range(npad // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        d = sq[:, None] + sq[None, sl] - 2.0 * (p @ p[sl].T)
        d = torch.clamp_min(d, 0.0)
        cols = torch.arange(j * chunk, (j + 1) * chunk, device=dev)[None, :]
        d = torch.where((rows == cols) | ~v[None, sl],
                        torch.full_like(d, big), d)
        merged = torch.cat([best, d], dim=1)
        best = torch.topk(merged, 4, dim=1, largest=False).values
    mean3 = torch.mean(best[:, :3], dim=1)
    mean3 = torch.where(v, mean3, torch.zeros_like(mean3))
    return mean3[:n]


def initial_log_scales(pts: torch.Tensor, valid: torch.Tensor | None = None,
                       eps: float = 1e-7) -> torch.Tensor:
    """log(sqrt(clamp(dist2, 1e-7))) tiled to 3 axes."""
    d2 = torch.clamp_min(mean_sq_dist_3nn(pts, valid), eps)
    s = 0.5 * torch.log(d2)
    return s[:, None].repeat(1, 3)
