"""Tile binning: depth order + per-tile instance runs
(port of ``freesurgs_tpu/ops/binning.py``).

The layout is the JAX binner's, slot for slot:

 1. Gaussians sorted front-to-back by camera depth (culled -> +inf keys);
 2. each expanded into one *instance* per covered bin tile, in depth order;
 3. a stable sort by tile id, so each tile's run stays depth-ordered —
    the CUDA (tile | depth) key sort;
 4. each tile's run re-packed at a CHUNK-aligned offset; padding slots
    point at index n, a dummy all-zero Gaussian.

Eager PyTorch needs no static shapes, so the instance buffer is allocated
at the exact padded total M on each call (one host read), capped at
``max_instances``. Past the cap the deepest instances of the suffix tiles
drop, as in the JAX binner at the same capacity, and are counted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import ProjectedGaussians

# Instances per kernel chunk; tile runs are aligned to it. The CUDA kernels
# stage one chunk of records in shared memory at a time.
CHUNK = 128


def derive_bin_rect(proj: ProjectedGaussians, scale: int
                    ) -> ProjectedGaussians:
    """Coarsen the 16 px tile rect to (16*scale) px binning granularity.

    Binning at 32x32 while the kernel masks each pixel with the original
    16 px rect is exactly the CUDA 16 px binning (a 16-rect containing a
    pixel's 16-tile overlaps the enclosing 32-tile), with fewer instances.
    """
    if scale == 1:
        return proj
    r = proj.tile_rect
    lo = torch.div(r[:, 0:2], scale, rounding_mode="floor")
    hi = -torch.div(-r[:, 2:4], scale, rounding_mode="floor")
    rect = torch.cat([lo, hi], dim=1)
    tiles = (hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1])
    on = proj.tiles_touched > 0
    tiles = torch.where(on, tiles, torch.zeros_like(tiles)).to(torch.int32)
    rect = torch.where(on[:, None], rect, torch.zeros_like(rect))
    return proj._replace(tile_rect=rect.to(torch.int32), tiles_touched=tiles)


class TileBins(NamedTuple):
    gather_idx: torch.Tensor    # (M,) slot -> Gaussian index (n = padding)
    tile_start: torch.Tensor    # (T,) int32 CHUNK-aligned run start per tile
    tile_count: torch.Tensor    # (T,) int32 real instances per tile
    num_instances: torch.Tensor  # () int32 kept instances
    overflow: torch.Tensor      # () int32 instances dropped at the cap
    # The per-Gaussian gradient sum's fixed order (ops/raster_cuda.py):
    sum_order: torch.Tensor     # (M,) int32 slots stably sorted by Gaussian
    sum_start: torch.Tensor     # (n + 1,) int32 where each Gaussian's run
    #                             of sum_order begins; [n] = first padding
    sum_rank: torch.Tensor      # (M,) int32 inverse of sum_order: the row
    #                             of the backward's sum-ordered output that
    #                             slot s's gradients go to


def sum_layout(gather_idx: torch.Tensor, n: int):
    """(sum_order, sum_start, sum_rank) of a slot -> Gaussian map: the slots
    stably sorted by Gaussian (each Gaussian's slots one run, in slot
    order), the offsets of the runs of Gaussians 0..n-1 (padding index n
    last, from sum_start[n] on), and the inverse permutation: slot s sits
    at position sum_rank[s] of the sorted order. All int32; no host read
    (the inverse is one scatter)."""
    held, order = torch.sort(gather_idx, stable=True)
    bounds = torch.arange(n + 1, dtype=held.dtype, device=held.device)
    start = torch.searchsorted(held, bounds, out_int32=True)
    order = order.to(torch.int32)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], dtype=torch.int32,
                               device=order.device)
    return order, start, rank


def padded_layout(tile_rect: torch.Tensor, grid_x: int, grid_y: int):
    """Per-tile instance counts of the full coverage (a 4-corner scatter +
    2D summed-area cumsum, independent of any capacity) and the
    CHUNK-aligned run starts. Returns (raw_count, padded_start, total_padded)
    with total_padded a host int."""
    dev = tile_rect.device
    num_tiles = grid_x * grid_y
    sat = torch.zeros((grid_y + 1) * (grid_x + 1), dtype=torch.int64,
                      device=dev)
    r0 = tile_rect.to(torch.int64)
    one = torch.ones(r0.shape[0], dtype=torch.int64, device=dev)
    w1 = grid_x + 1
    sat.index_add_(0, r0[:, 1] * w1 + r0[:, 0], one)
    sat.index_add_(0, r0[:, 1] * w1 + r0[:, 2], -one)
    sat.index_add_(0, r0[:, 3] * w1 + r0[:, 0], -one)
    sat.index_add_(0, r0[:, 3] * w1 + r0[:, 2], one)
    sat = sat.reshape(grid_y + 1, grid_x + 1).cumsum(0).cumsum(1)
    raw_count = sat[:grid_y, :grid_x].reshape(num_tiles)
    padded_count = -torch.div(-raw_count, CHUNK, rounding_mode="floor") * CHUNK
    padded_end = torch.cumsum(padded_count, 0)
    padded_start = padded_end - padded_count
    total_padded = int(padded_end[-1]) if num_tiles else 0
    return raw_count, padded_start, total_padded


def build_tile_bins(proj: ProjectedGaussians, grid_x: int, grid_y: int,
                    max_instances: int) -> TileBins:
    """Bin ``proj`` (rects already at bin granularity) into tile runs.

    The buffer holds M = min(padded total, max_instances rounded down to
    CHUNK) slots: the layout equals the JAX ``build_tile_bins`` at
    capacity M, which keeps it independent of how large a capacity the
    caller names.
    """
    dev = proj.depth.device
    n = proj.depth.shape[0]
    num_tiles = grid_x * grid_y
    cap = (max_instances // CHUNK) * CHUNK
    assert cap > 0, "max_instances must hold at least one CHUNK"

    raw_count, padded_start, total_padded = padded_layout(
        proj.tile_rect, grid_x, grid_y)
    m = min(total_padded, cap)

    key = torch.where(proj.radius > 0, proj.depth.detach(),
                      torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    counts = proj.tiles_touched[order].to(torch.int64)
    offsets = torch.cumsum(counts, 0)
    total = int(offsets[-1]) if n else 0
    # Expansion is in depth order, so at the cap the deepest instances drop.
    e = min(total, m)
    g = torch.repeat_interleave(torch.arange(n, device=dev), counts)[:e]
    local = torch.arange(e, device=dev) - (offsets - counts)[g]
    rect_g = proj.tile_rect[order][g].to(torch.int64)
    width_g = torch.clamp_min(rect_g[:, 2] - rect_g[:, 0], 1)
    tile_y = rect_g[:, 1] + torch.div(local, width_g, rounding_mode="floor")
    tile_x = rect_g[:, 0] + local % width_g
    tile_id = tile_y * grid_x + tile_x

    tile_sorted, perm = torch.sort(tile_id, stable=True)
    g_orig = order[g[perm]]
    # rank within the tile among expanded instances == rank in the full
    # coverage for every kept instance (a depth prefix of each tile)
    n_exp = torch.bincount(tile_sorted, minlength=num_tiles)
    raw_start = torch.cumsum(n_exp, 0) - n_exp
    rank = torch.arange(e, device=dev) - raw_start[tile_sorted]
    pos = padded_start[tile_sorted] + rank
    keep = pos < m
    gather_idx = torch.full((m,), n, dtype=torch.int64, device=dev)
    gather_idx[pos[keep]] = g_orig[keep]

    fit_count = torch.minimum(torch.clamp_min(m - padded_start, 0), raw_count)
    kept = keep.sum().to(torch.int32)
    sum_order, sum_start, sum_rank = sum_layout(gather_idx, n)
    return TileBins(gather_idx=gather_idx,
                    tile_start=padded_start.to(torch.int32),
                    tile_count=fit_count.to(torch.int32),
                    num_instances=kept,
                    overflow=(total - kept).to(torch.int32),
                    sum_order=sum_order, sum_start=sum_start,
                    sum_rank=sum_rank)
