"""Tile compositing, forward and backward: CUDA kernels for Hopper plus
their plain PyTorch versions (port of ``freesurgs_tpu/ops/raster_pallas.py``).

Instances are binned at 32x32 px (``ops/binning.py``); each pixel masks
contributions with the Gaussian's original 16 px tile rect, which is
exactly the CUDA 16 px binning with fewer instances. The records are
struct-of-arrays ``feat[10, M]`` (fields x instance slots):

  0 mean2d.x | 1 mean2d.y | 2 conic.a | 3 conic.b | 4 conic.c | 5 opacity
  6 r | 7 g | 8 b | 9 z

and the 16 px rect rides beside them as one int32 per slot, byte-packed
``tx0 | ty0 << 8 | tx1 << 16 | ty1 << 24``.

Compositing output, per pixel of the bin-padded image (8, Hp, Wp):
[r, g, b, z, 1, z^2] accumulated front to back, T_final, and the stop
index (slots of the pixel's tile run up to its last composited instance),
plus ``keff`` per tile: the CHUNKs composited before every pixel stopped.

The backward writes each slot's 10 gradients as one row of a sum-ordered
``dsum (M, 10)``: slot s goes to row ``sum_rank[s]`` of the layout
(``ops/binning.py``), so each Gaussian's slots are the contiguous rows
``sum_start[g]:sum_start[g + 1]``, in ascending slot order, and padding
slots come last. ``gaussian_grad_sum`` adds each run front to back from 0
(or from given sums, which it then continues: a band of a sharded render):
a fixed order, so training is reproducible from run to run on the card
(``index_add_``'s float atomics were not).

``RasterConfig.grad_sum = "prefix"`` takes the JAX package's default
reduction instead (``fast_binning=True``, ``raster_pallas.py:737-756``):
the layout then carries each slot's pre-slot index (``pre_rank``: its
place in the depth-major expansion) and each Gaussian's run of pre-slots
(``seg_lo`` / ``seg_hi``, ``ops/binning.py``). K2 writes slot s's row at
``pre_rank[s]``, and ``gaussian_grad_prefix`` forms each Gaussian's sum as
``csum[seg_hi] - csum[seg_lo]`` of one f32 prefix sum over all rows, in
the association order of ``jnp.cumsum`` on XLA's CPU backend
(``blocked_scan_plain``), so it equals the JAX reduction bit for bit on
the same rows. Kernel and plain version alike rebuild each csum value
top-down from the levels' block scans (``block_scans``,
``prefix_csum_at``): no level's scan is formed in full.

On a CUDA tensor ``composite_fwd`` / ``composite_bwd`` /
``gaussian_grad_sum`` / ``gaussian_grad_prefix`` launch the kernels in
``csrc/`` (built with nvcc on first use into ``_build/``, bound with
ctypes) and count the launch in ``LAUNCHES``; on a CPU tensor they run the
plain versions. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

from ..utils.profiling import span
from .binning import CHUNK, TileBins, build_tile_bins, derive_bin_rect
from .oracle import ALPHA_MIN, _order_terms, gaussian_alpha
from .projection import TILE, ProjectedGaussians, to_int32

N_OUT = 8          # [r, g, b, z, sil, z^2, T_final, stop index]
N_FIELD = 10       # live instance fields (rows of feat)
BIN = 32           # the kernels' bin tile side
NPIX = BIN * BIN

# Kernel launches since the last reset, counted where each kernel launches.
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0, "gaussian_grad_sum": 0,
            "gaussian_grad_prefix": 0}
# Binner runs and renders since the last reset: ``_bin_state`` counts the
# binner's runs (a render that reuses a carried layout does not run it),
# ``rasterize`` every render.
BINS = {"build_tile_bins": 0, "renders": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_bins() -> None:
    for k in BINS:
        BINS[k] = 0


# The backward's per-Gaussian reductions (``RasterConfig.grad_sum``).
GRAD_SUMS = ("direct", "prefix")


class RasterConfig(NamedTuple):
    """``grad_sum`` picks the backward's per-Gaussian reduction of the
    instance gradients: "direct" adds each Gaussian's own rows front to
    back (``gaussian_grad_sum``; the counterpart of the JAX
    ``fast_binning=False`` backward), "prefix" takes differences of one
    prefix sum over all rows in depth-major order
    (``gaussian_grad_prefix``): the JAX default, ``fast_binning=True``
    (``freesurgs_tpu/ops/raster_pallas.py:72``, its reduction at
    ``:737-756``)."""
    height: int
    width: int
    max_instances: int      # cap on the instance buffer (see ops/binning.py)
    grad_sum: str = "direct"

    bin_scale = BIN // TILE

    @property
    def grid_x(self) -> int:
        return -(-self.width // BIN)

    @property
    def grid_y(self) -> int:
        return -(-self.height // BIN)

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y


# ------------------------------------------------------ binning-side helpers

def snug_tile_rect(proj: ProjectedGaussians, opacity: torch.Tensor
                   ) -> ProjectedGaussians:
    """Shrink tile rects to the bounding box of {alpha >= 1/255} — exact.

    A pixel composites only inside the ellipse Q <= 2t, t = log(255 opac),
    whose axis-aligned half-widths are sqrt(2t C / det) and sqrt(2t A / det)
    (+0.5 px against f32 rounding). Intersecting the CUDA rect with that box
    removes only pixels that fail the in-kernel cutoff, so images and
    gradients are unchanged while the instance count drops. The float
    bounds are clipped to +/-1e9 before the int cast: a near-degenerate
    conic hits the 1e-24 det floor and would otherwise wrap int32.
    """
    A, B, C = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    det = torch.clamp_min(A * C - B * B, 1e-24)
    t2 = 2.0 * torch.log(torch.clamp_min(255.0 * opacity, 1.0))
    rx = torch.sqrt(t2 * C / det) + 0.5
    ry = torch.sqrt(t2 * A / det) + 0.5
    px, py = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.tile_rect
    tx0 = torch.maximum(r[:, 0], to_int32((px - rx) / TILE))
    ty0 = torch.maximum(r[:, 1], to_int32((py - ry) / TILE))
    tx1 = torch.minimum(r[:, 2], to_int32((px + rx) / TILE) + 1)
    ty1 = torch.minimum(r[:, 3], to_int32((py + ry) / TILE) + 1)
    w = torch.clamp_min(tx1 - tx0, 0)
    h = torch.clamp_min(ty1 - ty0, 0)
    zero = torch.zeros_like(w)
    tiles = torch.where(proj.tiles_touched > 0, w * h, zero).to(torch.int32)
    rect = torch.stack([tx0, ty0, tx1, ty1], dim=-1)
    rect = torch.where((tiles > 0)[:, None], rect, torch.zeros_like(rect))
    return proj._replace(tile_rect=rect.to(torch.int32), tiles_touched=tiles,
                         radius=torch.where(tiles > 0, proj.radius,
                                            torch.zeros_like(proj.radius)))


def _prune_and_snug(proj: ProjectedGaussians, opacity: torch.Tensor
                    ) -> ProjectedGaussians:
    """Exact pre-prune (peak alpha = opacity below 1/255 never composites)
    then the snug rects. Only integer fields change; differentiable fields
    pass through."""
    with torch.no_grad():
        keep = opacity.detach() >= ALPHA_MIN
        zi = torch.zeros_like(proj.radius)
        radius = torch.where(keep, proj.radius, zi)
        tiles = torch.where(keep, proj.tiles_touched, zi)
        rect = torch.where(keep[:, None], proj.tile_rect,
                           torch.zeros_like(proj.tile_rect))
        pb = proj._replace(radius=radius, tiles_touched=tiles, tile_rect=rect)
        snug = snug_tile_rect(ProjectedGaussians(
            *(x.detach() for x in pb)), opacity.detach())
    return pb._replace(tile_rect=snug.tile_rect,
                       tiles_touched=snug.tiles_touched, radius=snug.radius)


def effective_bin_tiles(proj: ProjectedGaussians, opacity: torch.Tensor,
                        bin_scale: int) -> torch.Tensor:
    """Per-Gaussian covered-bin count exactly as ``rasterize`` bins it."""
    return derive_bin_rect(_prune_and_snug(proj, opacity),
                           bin_scale).tiles_touched


def _field_cols(mean2d, conic, rgbz, opacity) -> torch.Tensor:
    """(N, 10) per-Gaussian instance fields (layout in the module doc)."""
    return torch.cat([mean2d, conic, opacity[:, None], rgbz], dim=1)


def _pack_rect(rect16: torch.Tensor) -> torch.Tensor:
    """(N, 4) 16 px rects -> (N,) int32, one byte per bound (images up to
    255 16 px tiles a side)."""
    r = rect16.to(torch.int64)
    packed = r[:, 0] | (r[:, 1] << 8) | (r[:, 2] << 16) | (r[:, 3] << 24)
    # wrap into int32 range (the top byte may set the sign bit)
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def _build_feat(fields: torch.Tensor, rect_packed: torch.Tensor,
                gather_idx: torch.Tensor):
    """Gather per-slot records: feat (10, M) f32 and rect (M,) int32.
    Slot index n reads an appended all-zero record (opacity 0, rect 0)."""
    src = torch.cat([fields, fields.new_zeros(1, N_FIELD)], dim=0)
    rsrc = torch.cat([rect_packed, rect_packed.new_zeros(1)], dim=0)
    feat = src[gather_idx].T.contiguous()
    return feat, rsrc[gather_idx].contiguous()


# ------------------------------------------------------- plain versions

def _tile_views(img: torch.Tensor, grid_x: int, grid_y: int) -> torch.Tensor:
    """(C, Hp, Wp) image -> (gy, gx, C, BIN, BIN) view onto it."""
    c = img.shape[0]
    return img.view(c, grid_y, BIN, grid_x, BIN).permute(1, 3, 0, 2, 4)


# Element budget of one plain-version tile batch: (tiles x pixels x slots)
# per temporary, 64 MiB in f32.
PLAIN_BATCH_ELEMS = 1 << 24


def _tile_batches(counts: torch.Tensor, budget: int = PLAIN_BATCH_ELEMS):
    """Group non-empty tiles (largest first) so that each batch's padded
    (tiles x pixels x instances) stays within ``budget`` elements."""
    cnt = counts.tolist()
    order = sorted((t for t, c in enumerate(cnt) if c > 0),
                   key=lambda t: -cnt[t])
    batch: list[int] = []
    for t in order:
        if batch and (len(batch) + 1) * cnt[batch[0]] * NPIX > budget:
            yield batch
            batch = []
        batch.append(t)
    if batch:
        yield batch


def _batch_inputs(starts, counts, tiles, device):
    tl = torch.as_tensor(tiles, device=device)
    cnt = counts[tl].to(torch.int64)
    L = int(cnt.max())
    j = torch.arange(L, device=device)
    slot_ok = j[None, :] < cnt[:, None]                       # (B, L)
    idx = starts[tl].to(torch.int64)[:, None] + j[None, :]
    idx = torch.where(slot_ok, idx, torch.zeros_like(idx))
    return tl, slot_ok, idx


def _tile_alpha(feat_b, rect_b, slot_ok, tl, grid_x, rect_mask=True):
    """Alphas of a batch of B tiles with L slots each, at every pixel.

    feat_b (10, B, L), rect_b (B, L) int32, slot_ok (B, L) bool.
    Returns (abar (B, NPIX, L), 0 where a cutoff fails or the 16 px rect
    misses the pixel; tested (B, NPIX, L), the slot's rect covers the
    pixel). ``rect_mask=False`` lets every rect cover every pixel (the
    ablation's ``norect``).
    """
    dev = feat_b.device
    p = torch.arange(NPIX, device=dev)
    tx = (tl % grid_x)[:, None]
    ty = torch.div(tl, grid_x, rounding_mode="floor")[:, None]
    ix = tx * BIN + p % BIN                                  # (B, NPIX)
    iy = ty * BIN + torch.div(p, BIN, rounding_mode="floor")
    f = feat_b[:, :, None, :]                                # (10, B, 1, L)
    opac = torch.where(slot_ok[:, None, :], f[5], torch.zeros_like(f[5]))
    abar = gaussian_alpha(f[0], f[1], f[2], f[3], f[4], opac,
                          ix.to(feat_b.dtype)[:, :, None],
                          iy.to(feat_b.dtype)[:, :, None])   # (B, NPIX, L)
    if rect_mask:
        r = rect_b[:, None, :]
        x16 = (ix >> 4)[:, :, None]
        y16 = (iy >> 4)[:, :, None]
        in_rect = ((x16 >= (r & 0xFF)) & (x16 < ((r >> 16) & 0xFF))
                   & (y16 >= ((r >> 8) & 0xFF)) & (y16 < ((r >> 24) & 0xFF)))
        tested = in_rect & slot_ok[:, None, :]
    else:
        tested = slot_ok[:, None, :].expand(abar.shape)
    return torch.where(tested, abar, torch.zeros_like(abar)), tested


def _composite_tiles(feat_b, rect_b, slot_ok, tl, grid_x, stop=True,
                     rect_mask=True, linear_t=False):
    """Plain composite of a batch of B tiles with L slots each (arguments
    as ``_tile_alpha``; the switches as ``composite_fwd_plain``'s).

    Returns (img (B, 6, NPIX), T_final (B, NPIX), stop_idx (B, NPIX) int64,
    first_cross (B, NPIX) int64 with L meaning never crossed).
    """
    abar, _ = _tile_alpha(feat_b, rect_b, slot_ok, tl, grid_x, rect_mask)
    w, T_final, valid, crossed_incl = _order_terms(abar, dim=2, stop=stop,
                                                   linear_t=linear_t)
    z = feat_b[9]
    cols = torch.stack([feat_b[6], feat_b[7], feat_b[8], z,
                        torch.ones_like(z), z * z], dim=-1)  # (B, L, 6)
    img = torch.einsum("bpl,blc->bcp", w, cols)
    L = abar.shape[2]
    rank = torch.arange(1, L + 1, device=feat_b.device)
    stop_idx = (valid * rank).amax(dim=2)
    first_cross = L - (crossed_incl > 0).sum(dim=2)
    return img, T_final, stop_idx, first_cross


def composite_fwd_plain(feat: torch.Tensor, rect: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        grid_x: int, grid_y: int, *, stop: bool = True,
                        rect_mask: bool = True, linear_t: bool = False):
    """Plain PyTorch forward on the binned records, tile batch by tile
    batch, with the log-space cumsum of ``ops/oracle.py``.
    Returns (out (8, Hp, Wp), keff (T,) int32).

    The switches, each off in one variant of the kernel ablation
    (``ops/raster_ablate.py``): ``stop`` the T < 1e-4 stop, ``rect_mask``
    the 16 px rect mask; ``linear_t`` carries T as a running product."""
    dev = feat.device
    out = torch.zeros(N_OUT, grid_y * BIN, grid_x * BIN, dtype=feat.dtype,
                      device=dev)
    out[6] = 1.0
    keff = torch.zeros(grid_x * grid_y, dtype=torch.int32, device=dev)
    tiles_out = _tile_views(out, grid_x, grid_y)
    for tiles in _tile_batches(counts):
        tl, slot_ok, idx = _batch_inputs(starts, counts, tiles, dev)
        img, T_final, stop_idx, first_cross = _composite_tiles(
            feat[:, idx], rect[idx], slot_ok, tl, grid_x, stop, rect_mask,
            linear_t)
        vals = torch.cat([img, T_final[:, None],
                          stop_idx[:, None].to(img.dtype)], dim=1)
        ty = torch.div(tl, grid_x, rounding_mode="floor")
        tiles_out[ty, tl % grid_x] = vals.view(-1, N_OUT, BIN, BIN)
        n_chunks = -torch.div(-counts[tl], CHUNK, rounding_mode="floor")
        L = slot_ok.shape[1]
        all_crossed = (first_cross < L).all(dim=1)
        last = torch.div(first_cross.amax(dim=1), CHUNK,
                         rounding_mode="floor") + 1
        keff[tl] = torch.where(all_crossed, last.to(torch.int32),
                               n_chunks.to(torch.int32))
    return out, keff


def composite_bwd_plain(feat: torch.Tensor, rect: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        gout: torch.Tensor, sum_rank: torch.Tensor,
                        grid_x: int, grid_y: int) -> torch.Tensor:
    """Plain backward: autograd through ``composite_fwd_plain``'s tile
    batches. gout (8, Hp, Wp) is the cotangent of the image channels 0-5
    and T_final (channel 6). Returns dsum (M, 10) in sum order: row
    sum_rank[s] holds slot s's gradient, zero on slots no tile run
    covers."""
    dev = feat.device
    dfeat = torch.zeros_like(feat)
    g_tiles = _tile_views(gout, grid_x, grid_y)
    for tiles in _tile_batches(counts):
        tl, slot_ok, idx = _batch_inputs(starts, counts, tiles, dev)
        fb = feat[:, idx].detach().requires_grad_(True)
        with torch.enable_grad():
            img, T_final, _, _ = _composite_tiles(fb, rect[idx], slot_ok, tl,
                                                  grid_x)
            ty = torch.div(tl, grid_x, rounding_mode="floor")
            g = g_tiles[ty, tl % grid_x].reshape(len(tiles), N_OUT, NPIX)
            (db,) = torch.autograd.grad((img, T_final), (fb,),
                                        (g[:, 0:6], g[:, 6]))
        dfeat[:, idx[slot_ok]] = db[:, slot_ok]
    dsum = dfeat.new_empty(dfeat.shape[1], N_FIELD)
    dsum[sum_rank] = dfeat.T
    return dsum


def gaussian_grad_sum_plain(dsum: torch.Tensor, start: torch.Tensor,
                            init: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Plain per-Gaussian sum: (n, 10), row g the sum of the sum-ordered
    rows ``dsum[start[g]:start[g + 1]]``, added front to back from 0, or
    from ``init``'s row g (rank r of every run in one step), the kernel's
    order."""
    n = start.shape[0] - 1
    st = start.to(torch.int64)
    lens = st[1:] - st[:-1]
    out = dsum.new_zeros(n, N_FIELD) if init is None else init.clone()
    for r in range(int(lens.max()) if n else 0):
        g = torch.nonzero(lens > r).squeeze(1)
        out[g] += dsum[st[g] + r]
    return out


# Block length of the prefix sum's association order (below).
SCAN_BASE = 16


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along dim 1 of (B, L, C), one f32 add at a time from
    +0 (``torch.cumsum`` on the CPU accumulates in double)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
        out[:, j] = acc
    return out


def blocked_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 scan of x (L, C) along dim 0 in the association order
    of ``jnp.cumsum`` on XLA's CPU backend (its reduce-window rewrite with
    base length 16), bit for bit: zero-pad to a multiple of 16 rows, scan
    each block of 16 sequentially from +0, scan the blocks' totals (each
    block's last row) by the same rule, and add to each block the scan of
    the totals before it (+0 to the first), one f32 add. At most 16 rows
    are one sequential scan, with nothing added."""
    n_rows, c = x.shape
    if n_rows <= SCAN_BASE:
        return _sequential_scan(x[None])[0]
    nb = -(-n_rows // SCAN_BASE)
    xp = torch.cat([x, x.new_zeros(nb * SCAN_BASE - n_rows, c)])
    within = _sequential_scan(xp.view(nb, SCAN_BASE, c))
    upper = blocked_scan_plain(within[:, -1])
    before = torch.cat([upper.new_zeros(1, c), upper[:-1]])
    return (within + before[:, None]).view(nb * SCAN_BASE, c)[:n_rows]


def scan_levels(m: int) -> list[int]:
    """Row counts of the prefix sum's upper levels over m rows: the block
    totals of each level until one has at most 16 rows (824,341 rows:
    51,522, 3,221, 202, 13)."""
    levels = []
    while m > SCAN_BASE:
        m = -(-m // SCAN_BASE)
        levels.append(m)
    return levels


def block_scans(x: torch.Tensor) -> list[torch.Tensor]:
    """The levels of ``blocked_scan_plain``'s order over x (L, C): W_0, the
    scan of each block of 16 rows from +0 (zero-padded), then W_1 the same
    over the blocks' totals, and so on up to the first level with at most
    16 rows (the top, whose W is its whole scan)."""
    levels = []
    while True:
        n_rows, c = x.shape
        nb = -(-n_rows // SCAN_BASE)
        xp = torch.cat([x, x.new_zeros(nb * SCAN_BASE - n_rows, c)])
        within = _sequential_scan(xp.view(nb, SCAN_BASE, c))
        levels.append(within.view(nb * SCAN_BASE, c)[:n_rows])
        if n_rows <= SCAN_BASE:
            return levels
        x = within[:, -1]


def prefix_csum_at(levels: list[torch.Tensor], k: torch.Tensor
                   ) -> torch.Tensor:
    """The zero-prefixed scan at k (B,), (B, C), rebuilt top-down from the
    levels' block scans (``block_scans``): S_top = W_top and S_l[i] =
    W_l[i] + S_{l+1}[i // 16 - 1], the add skipped where i // 16 = 0 (it
    adds +0 to a sum begun at +0, which is never -0: no bit changes);
    csum[k] = S_0[k - 1], csum[0] = +0. Bitwise ``blocked_scan_plain``."""
    idx = [k.long() - 1]
    for _ in levels[1:]:
        idx.append(torch.div(idx[-1], SCAN_BASE, rounding_mode="floor") - 1)
    s = None
    for w, i in zip(reversed(levels), reversed(idx)):
        wi = w[i.clamp_min(0)]
        s = wi if s is None else torch.where(above[:, None], wi + s, wi)
        above = i >= 0
    return torch.where(above[:, None], s, torch.zeros_like(s))


def gaussian_grad_prefix_plain(pre: torch.Tensor, seg_lo: torch.Tensor,
                               seg_hi: torch.Tensor) -> torch.Tensor:
    """Plain prefix reduction: (n, 10), row g ``csum[seg_hi[g]] -
    csum[seg_lo[g]]`` with csum the zero-prefixed ``blocked_scan_plain`` of
    the pre-slot-ordered rows ``pre`` (M, 10), each value rebuilt top-down
    from the levels' block scans as the kernel rebuilds it
    (``prefix_csum_at``): the JAX ``fast_binning`` backward's ``dsrc`` on
    the same rows, bit for bit."""
    if pre.shape[0] == 0:
        return pre.new_zeros(seg_lo.shape[0], pre.shape[1])
    levels = block_scans(pre)
    return prefix_csum_at(levels, seg_hi) - prefix_csum_at(levels, seg_lo)


def prefix_scratch_words(m: int) -> int:
    """Floats of ``gaussian_grad_prefix``'s scratch for m rows (its source
    note has the layout): W_0, W_1, level 2's entries, and level 3's and
    those above it, 10 a row."""
    l1 = -(-m // SCAN_BASE)
    l2 = -(-l1 // SCAN_BASE)
    l3 = -(-l2 // SCAN_BASE)
    return N_FIELD * (m + l1 + l2 + l3 + sum(scan_levels(l3)))


def composite_pair_counts(feat: torch.Tensor, rect: torch.Tensor,
                          starts: torch.Tensor, counts: torch.Tensor,
                          grid_x: int, *, stop: bool = True,
                          rect_mask: bool = True,
                          linear_t: bool = False) -> dict[str, int]:
    """The (instance, pixel) pairs that need float work in the compositing
    of these records (under ``composite_fwd_plain``'s switches), by kind,
    for the kernels' operation bound:

      blended  composited into the pixel (alpha, transmittance test, blend);
      stopping the pair at which a pixel stops (alpha and the test only);
      cut      the rect covers the pixel before its stop, but alpha fails a
               cutoff (power and exp only).

    A pair whose rect misses the pixel (one integer test) or that comes
    after its pixel's stop needs none."""
    tot = {"blended": 0, "stopping": 0, "cut": 0}
    with torch.no_grad():
        for tiles in _tile_batches(counts):
            tl, slot_ok, idx = _batch_inputs(starts, counts, tiles,
                                             feat.device)
            abar, tested = _tile_alpha(feat[:, idx], rect[idx], slot_ok, tl,
                                       grid_x, rect_mask)
            _, _, valid, crossed_incl = _order_terms(abar, dim=2, stop=stop,
                                                     linear_t=linear_t)
            tot["blended"] += int(valid.sum())
            tot["stopping"] += int((crossed_incl[..., -1] > 0).sum())
            tot["cut"] += int((tested & (crossed_incl == 0)
                               & (abar == 0)).sum())
    return tot


# ------------------------------------------------------- kernel build + launch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = {"composite_fwd": "composite_fwd.cu",
                  "composite_bwd": "composite_bwd.cu",
                  "composite_fwd_ablate": "composite_fwd_ablate.cu",
                  "gaussian_grad_sum": "gaussian_grad_sum.cu",
                  "gaussian_grad_prefix": "gaussian_grad_prefix.cu"}
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict = {}          # symbol -> bound ctypes function


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return cand


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def _compile(name: str) -> str:
    """nvcc one source into its shared library; returns ptxas's report."""
    dst = _lib_path(name)
    src = CSRC / KERNEL_SOURCES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-I", str(CSRC), "-o", tmp, str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stderr}")
    os.replace(tmp, dst)
    return res.stderr


def build_kernels() -> dict[str, str]:
    """Build every kernel library that is missing, one nvcc per source, all
    started together. Returns {name: ptxas report} for those built now."""
    todo = [n for n in KERNEL_SOURCES if not _lib_path(n).exists()]
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as ex:
        reports = dict(zip(todo, ex.map(_compile, todo)))
    return reports


def kernel_fn(lib_name: str, symbol: str, n_ptr: int, n_int: int = 3):
    """The C entry point ``symbol`` of library ``lib_name`` (built first if
    missing): ``n_ptr`` pointers, then ``n_int`` ints (the compositing
    kernels': M, grid_x, num_tiles) and the stream."""
    fn = _FNS.get(symbol)
    if fn is None:
        lib = _LIBS.get(lib_name)
        if lib is None:
            path = _lib_path(lib_name)
            if not path.exists():
                build_kernels()
            lib = _LIBS[lib_name] = ctypes.CDLL(str(path))
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        _FNS[symbol] = fn
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch_inputs(feat, rect, starts, counts, grid_x, grid_y):
    dev = feat.device
    m = feat.shape[1]
    nt = grid_x * grid_y
    _check(feat, "feat", torch.float32, (N_FIELD, m), dev)
    _check(rect, "rect", torch.int32, (m,), dev)
    _check(starts, "starts", torch.int32, (nt,), dev)
    _check(counts, "counts", torch.int32, (nt,), dev)
    if m >= 2 ** 31 // N_FIELD:
        raise ValueError(f"instance buffer too large for int32 offsets: {m}")
    # the kernels stage each chunk's field rows by 512 B bulk copies
    if m % CHUNK:
        raise ValueError(f"instance buffer {m} is not a multiple of {CHUNK}")
    for name, t in (("feat", feat), ("rect", rect)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return dev, m, nt


def launch_fwd(fn, feat: torch.Tensor, rect: torch.Tensor,
               starts: torch.Tensor, counts: torch.Tensor, grid_x: int,
               grid_y: int):
    """Launch a forward-shaped kernel (K1 or an ablation variant) on CUDA
    tensors: (out (8, Hp, Wp), keff (T,) int32). Raises if the launch
    fails."""
    dev, m, nt = _launch_inputs(feat, rect, starts, counts, grid_x, grid_y)
    hp, wp = grid_y * BIN, grid_x * BIN
    out = torch.empty(N_OUT, hp, wp, dtype=torch.float32, device=dev)
    keff = torch.empty(nt, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feat.data_ptr(), rect.data_ptr(), starts.data_ptr(),
                 counts.data_ptr(), out.data_ptr(), keff.data_ptr(),
                 m, grid_x, nt, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return out, keff


def composite_fwd(feat: torch.Tensor, rect: torch.Tensor,
                  starts: torch.Tensor, counts: torch.Tensor,
                  grid_x: int, grid_y: int):
    """Forward compositing: (out (8, Hp, Wp), keff (T,) int32)."""
    if not feat.is_cuda:
        return composite_fwd_plain(feat, rect, starts, counts, grid_x, grid_y)
    res = launch_fwd(kernel_fn("composite_fwd", "composite_fwd", 6), feat,
                     rect, starts, counts, grid_x, grid_y)
    LAUNCHES["composite_fwd"] += 1
    return res


def composite_bwd(feat: torch.Tensor, rect: torch.Tensor,
                  starts: torch.Tensor, counts: torch.Tensor,
                  keff: torch.Tensor, out: torch.Tensor, gout: torch.Tensor,
                  sum_rank: torch.Tensor, grid_x: int,
                  grid_y: int) -> torch.Tensor:
    """Backward compositing: dsum (M, 10), slot s's gradients in row
    sum_rank[s] (int32, a permutation of the slots: ``binning.sum_layout``,
    or the layout's ``pre_rank`` for the prefix reduction)."""
    if not feat.is_cuda:
        return composite_bwd_plain(feat, rect, starts, counts, gout,
                                   sum_rank, grid_x, grid_y)
    dev, m, nt = _launch_inputs(feat, rect, starts, counts, grid_x, grid_y)
    img_shape = (N_OUT, grid_y * BIN, grid_x * BIN)
    _check(keff, "keff", torch.int32, (nt,), dev)
    _check(out, "out", torch.float32, img_shape, dev)
    _check(gout, "gout", torch.float32, img_shape, dev)
    _check(sum_rank, "sum_rank", torch.int32, (m,), dev)
    # each chunk's ranks arrive with its records by a 512 B bulk copy
    if sum_rank.data_ptr() % 16:
        raise ValueError("sum_rank is not 16-byte aligned")
    dsum = torch.empty(m, N_FIELD, dtype=torch.float32, device=dev)
    fn = kernel_fn("composite_bwd", "composite_bwd", 9)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feat.data_ptr(), rect.data_ptr(), starts.data_ptr(),
                 counts.data_ptr(), keff.data_ptr(), out.data_ptr(),
                 gout.data_ptr(), sum_rank.data_ptr(), dsum.data_ptr(), m,
                 grid_x, nt, stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd launch failed: CUDA error {err}")
    LAUNCHES["composite_bwd"] += 1
    return dsum


def gaussian_grad_sum(dsum: torch.Tensor, start: torch.Tensor,
                      init: torch.Tensor | None = None) -> torch.Tensor:
    """Per-Gaussian sum of per-instance gradients, in a fixed order:
    (n, 10) from the sum-ordered dsum (M, 10) and start (n + 1,) int32
    (``binning.sum_layout``), each row's sum started from ``init``'s
    (n, 10) row when given (it then continues init's sums, bit for
    bit)."""
    if not dsum.is_cuda:
        return gaussian_grad_sum_plain(dsum, start, init)
    dev = dsum.device
    m = dsum.shape[0]
    n = start.shape[0] - 1
    _check(dsum, "dsum", torch.float32, (m, N_FIELD), dev)
    _check(start, "start", torch.int32, (n + 1,), dev)
    for name, t in (("dsum", dsum), ("init", init)):
        if t is not None and t.data_ptr() % 8:   # rows read as 8 B pairs
            raise ValueError(f"{name} is not 8-byte aligned")
    if init is not None:
        _check(init, "init", torch.float32, (n, N_FIELD), dev)
    out = torch.empty(n, N_FIELD, dtype=torch.float32, device=dev)
    fn = kernel_fn("gaussian_grad_sum", "gaussian_grad_sum", 4, n_int=1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dsum.data_ptr(), start.data_ptr(),
                 None if init is None else init.data_ptr(), out.data_ptr(),
                 n, stream)
    if err != 0:
        raise RuntimeError(f"gaussian_grad_sum launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["gaussian_grad_sum"] += 1
    return out


def gaussian_grad_prefix(pre: torch.Tensor, seg_lo: torch.Tensor,
                         seg_hi: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian sum as a difference of prefix sums, the JAX
    ``fast_binning`` backward's: (n, 10) from the pre-slot-ordered rows
    ``pre`` (M, 10) and each Gaussian's run [seg_lo, seg_hi) (int32,
    ``binning.build_tile_bins(pre_slots=True)``), bit for bit
    ``gaussian_grad_prefix_plain``. Two launches, three past ~1.2 million
    rows (``csrc/gaussian_grad_prefix.cu``)."""
    if not pre.is_cuda:
        return gaussian_grad_prefix_plain(pre, seg_lo, seg_hi)
    dev = pre.device
    m = pre.shape[0]
    n = seg_lo.shape[0]
    _check(pre, "pre", torch.float32, (m, N_FIELD), dev)
    _check(seg_lo, "seg_lo", torch.int32, (n,), dev)
    _check(seg_hi, "seg_hi", torch.int32, (n,), dev)
    if m >= 2 ** 31 // N_FIELD:
        raise ValueError(f"instance buffer too large for int32 offsets: {m}")
    if pre.data_ptr() % 16:      # the kernel reads pre 16 B a load
        raise ValueError("pre is not 16-byte aligned")
    words = prefix_scratch_words(m)
    scratch = torch.empty(words, dtype=torch.float32, device=dev)
    out = torch.empty(n, N_FIELD, dtype=torch.float32, device=dev)
    fn = kernel_fn("gaussian_grad_prefix", "gaussian_grad_prefix", 5,
                   n_int=3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pre.data_ptr(), seg_lo.data_ptr(), seg_hi.data_ptr(),
                 scratch.data_ptr(), out.data_ptr(), m, n, words, stream)
    if err != 0:
        raise RuntimeError(f"gaussian_grad_prefix launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["gaussian_grad_prefix"] += 1
    return out


# ------------------------------------------------------------- autograd

class Composite(torch.autograd.Function):
    """Differentiable compositing of binned Gaussians (the counterpart of
    ``_make_composite``'s custom_vjp). Binning stays outside: depth order
    and integer rects carry no gradient, as in the CUDA sort stage.

    Returns the (8, Hp, Wp) output; channels 0-6 are differentiable
    (T_final's cotangent is the g_T of the backward kernel). K2 writes slot
    s's gradients to row ``row_rank[s]``; ``reduce`` maps those (M, 10) rows
    to the (n, 10) per-Gaussian sums (``rasterize`` picks both from
    ``RasterConfig.grad_sum``)."""

    @staticmethod
    def forward(ctx, mean2d, conic, rgbz, opacity, rect16, gather_idx,
                tile_start, tile_count, row_rank, grid_x, grid_y, reduce):
        feat, rect = _records(mean2d, conic, rgbz, opacity, rect16,
                              gather_idx)
        out, keff = composite_fwd(feat, rect, tile_start, tile_count,
                                  grid_x, grid_y)
        ctx.save_for_backward(feat, rect, tile_start, tile_count, keff, out,
                              row_rank)
        ctx.grid = (grid_x, grid_y)
        ctx.reduce = reduce
        return out

    @staticmethod
    def backward(ctx, gout):
        feat, rect, starts, counts, keff, out, row_rank = ctx.saved_tensors
        gx, gy = ctx.grid
        with span("k2"):
            dsum = composite_bwd(feat, rect, starts, counts, keff, out,
                                 gout.contiguous(), row_rank, gx, gy)
        # per-Gaussian sums in a fixed order; padding rows add nothing
        with span("grad_sum"):
            dsrc = ctx.reduce(dsum)
        return (dsrc[:, 0:2], dsrc[:, 2:5], dsrc[:, 6:10], dsrc[:, 5],
                None, None, None, None, None, None, None, None)


# ------------------------------------------------------ the layout carry
#
# A binning layout (``TileBins``: gather_idx, tile_start, tile_count,
# num_instances, overflow, the sum layout sum_order / sum_start / sum_rank,
# and under grad_sum="prefix" the fast binner's pre_rank / seg_lo / seg_hi)
# is the port's counterpart of the JAX ``BinState``
# (``raster_pallas.py:639-685``). Carried across optimizer steps it
# skips the binner, and its two host reads, under the JAX contract:
#
# - every call prunes and snugs the CURRENT parameters and regathers the
#   current fields and packed 16 px rect through the carried gather_idx,
#   so the kernels mask each pixel against the fresh rect and the fresh
#   alpha cutoffs: an instance whose Gaussian moved away, faded below
#   1/255 or was pruned (its rect is then 0) adds exactly zero value and
#   zero gradient;
# - a Gaussian that grew or moved beyond its binned coverage loses that
#   sliver until the next rebin (the one approximation);
# - gradients are the exact VJP of the stale forward: K1 and K2 read the
#   same carried layout within one call, so K2's replay from K1's stop
#   index and keff refer to the same runs;
# - a slot may hold another Gaussian after densify or a capacity change:
#   the caller rebins after any slot surgery, and a carry never outlives
#   the call that made it (slot index n is padding for the n it was
#   binned with).
#
# The tensors of a layout are never written in place (``Composite`` saves
# them for the backward's version check). A layout is made by a fresh
# render (``render(rebin=True)``, the JAX ``compute_bin_state``); there is
# no ``zero_bin_state``: an eager loop starts its carry from None with a
# forced rebin.


def _bin_state(proj_b: ProjectedGaussians, cfg: RasterConfig) -> TileBins:
    """Bin pruned + snugged projections at the bin granularity."""
    with torch.no_grad():
        bins = build_tile_bins(derive_bin_rect(proj_b, cfg.bin_scale),
                               cfg.grid_x, cfg.grid_y, cfg.max_instances,
                               pre_slots=cfg.grad_sum == "prefix")
    BINS["build_tile_bins"] += 1
    return bins


def _reuse_overflow(proj_b: ProjectedGaussians, cfg: RasterConfig
                    ) -> torch.Tensor:
    """``overflow`` of a render on a carried layout, JAX's quantity: the
    instances the current snug coverage exceeds the capacity by,
    max(0, sum of bin coverage - capacity), on the device with no host
    read. It sees neither the sliver a stale layout loses nor CHUNK
    padding (a fresh render counts what it actually dropped)."""
    with torch.no_grad():
        total = derive_bin_rect(proj_b, cfg.bin_scale).tiles_touched.sum()
        cap = (cfg.max_instances // CHUNK) * CHUNK
        return torch.clamp_min(total - cap, 0).to(torch.int32)


def _records(mean2d, conic, rgbz, opacity, rect16, gather_idx):
    """The per-slot records the kernels read: feat (10, M), rect (M,)."""
    return _build_feat(_field_cols(mean2d, conic, rgbz, opacity),
                       _pack_rect(rect16), gather_idx)


def instance_records(proj: ProjectedGaussians, rgbz: torch.Tensor,
                     opacity: torch.Tensor, cfg: RasterConfig):
    """The binned records ``rasterize`` hands the kernels, made by the same
    two steps, without autograd: (feat (10, M), rect (M,), TileBins). For
    checking and timing the kernels on a real layout."""
    with torch.no_grad():
        proj_b = _prune_and_snug(proj, opacity)
        bins = _bin_state(proj_b, cfg)
        feat, rect = _records(proj_b.mean2d, proj_b.conic, rgbz, opacity,
                              proj_b.tile_rect, bins.gather_idx)
    return feat, rect, bins


def _reduction(cfg: RasterConfig, bins: TileBins, band_sum):
    """K2's row map and the per-Gaussian reduction ``cfg.grad_sum`` names,
    on this layout (with ``band_sum``: a band's, as ``rasterize`` says)."""
    if cfg.grad_sum == "direct":
        return bins.sum_rank, functools.partial(
            band_sum or gaussian_grad_sum, start=bins.sum_start)
    if cfg.grad_sum != "prefix":
        raise ValueError(f"grad_sum={cfg.grad_sum!r}: one of {GRAD_SUMS}")
    if bins.pre_rank is None:
        raise ValueError("grad_sum='prefix' needs a layout binned with it "
                         "(pre_rank / seg_lo / seg_hi); this one was "
                         "binned for grad_sum='direct'")
    own = functools.partial(gaussian_grad_prefix, seg_lo=bins.seg_lo,
                            seg_hi=bins.seg_hi)
    if band_sum is None:
        return bins.pre_rank, own
    return bins.pre_rank, lambda pre: band_sum(own(pre))


def rasterize(proj: ProjectedGaussians, rgbz: torch.Tensor,
              opacity: torch.Tensor, cfg: RasterConfig,
              bins: TileBins | None = None, band_sum=None):
    """Rasterize projected Gaussians through the compositing kernels.

    rgbz: (N, 4) per-Gaussian [r, g, b, z]; opacity: (N,) in [0, 1].
    bins: a carried layout to reuse (see the layout carry above); None
    bins fresh. ``cfg.grad_sum`` picks the backward's per-Gaussian
    reduction (``RasterConfig``); a "prefix" carry must have been binned
    with it. band_sum: how a band of a sharded render completes the whole
    image's per-Gaussian sums (``parallel/sharded.py``): under "direct" it
    is the reduction, called as ``band_sum(dsum, start=...)``, which
    continues the bands above it; under "prefix" it takes the band's own
    (n, 10) prefix reduction and returns the bands' sum.
    Returns {"image": (6, H, W) [r, g, b, z, sil, z^2] without background,
    "final_T": (H, W), "overflow": () instances dropped at the cap (on a
    carried layout: ``_reuse_overflow``), "num_instances": () instances in
    the layout, "bins": the layout used}.
    """
    BINS["renders"] += 1
    with span("bin"):
        proj_b = _prune_and_snug(proj, opacity)
        if bins is None:
            bins = _bin_state(proj_b, cfg)
            overflow = bins.overflow
        else:
            overflow = _reuse_overflow(proj_b, cfg)
    row_rank, reduce = _reduction(cfg, bins, band_sum)
    out = Composite.apply(proj_b.mean2d, proj_b.conic, rgbz, opacity,
                          proj_b.tile_rect, bins.gather_idx, bins.tile_start,
                          bins.tile_count, row_rank, cfg.grid_x, cfg.grid_y,
                          reduce)
    out = out[:, :cfg.height, :cfg.width]
    return {"image": out[0:6], "final_T": out[6], "overflow": overflow,
            "num_instances": bins.num_instances, "bins": bins}
