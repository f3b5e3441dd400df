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
slots come last. ``gaussian_grad_sum`` adds each run front to back from 0:
a fixed order, so training is reproducible from run to run on the card
(``index_add_``'s float atomics were not).

On a CUDA tensor ``composite_fwd`` / ``composite_bwd`` /
``gaussian_grad_sum`` launch the kernels in ``csrc/`` (built with nvcc on
first use into ``_build/``, bound with ctypes) and count the launch in
``LAUNCHES``; on a CPU tensor they run the plain versions. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

from .binning import CHUNK, TileBins, build_tile_bins, derive_bin_rect
from .oracle import ALPHA_MIN, _order_terms, gaussian_alpha
from .projection import TILE, ProjectedGaussians, to_int32

N_OUT = 8          # [r, g, b, z, sil, z^2, T_final, stop index]
N_FIELD = 10       # live instance fields (rows of feat)
BIN = 32           # the kernels' bin tile side
NPIX = BIN * BIN

# Kernel launches since the last reset, counted where each kernel launches.
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0, "gaussian_grad_sum": 0}
# Binner runs since the last reset, counted where the binner runs
# (``_bin_state``): a render that reuses a carried layout does not count.
BINS = {"build_tile_bins": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_bins() -> None:
    BINS["build_tile_bins"] = 0


class RasterConfig(NamedTuple):
    height: int
    width: int
    max_instances: int      # cap on the instance buffer (see ops/binning.py)

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


def gaussian_grad_sum_plain(dsum: torch.Tensor,
                            start: torch.Tensor) -> torch.Tensor:
    """Plain per-Gaussian sum: (n, 10), row g the sum of the sum-ordered
    rows ``dsum[start[g]:start[g + 1]]``, added front to back from 0 (rank
    r of every run in one step), the kernel's order."""
    n = start.shape[0] - 1
    st = start.to(torch.int64)
    lens = st[1:] - st[:-1]
    out = dsum.new_zeros(n, N_FIELD)
    for r in range(int(lens.max()) if n else 0):
        g = torch.nonzero(lens > r).squeeze(1)
        out[g] += dsum[st[g] + r]
    return out


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
                  "gaussian_grad_sum": "gaussian_grad_sum.cu"}
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
    sum_rank[s] (int32, ``binning.sum_layout``)."""
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


def gaussian_grad_sum(dsum: torch.Tensor,
                      start: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian sum of per-instance gradients, in a fixed order:
    (n, 10) from the sum-ordered dsum (M, 10) and start (n + 1,) int32
    (``binning.sum_layout``)."""
    if not dsum.is_cuda:
        return gaussian_grad_sum_plain(dsum, start)
    dev = dsum.device
    m = dsum.shape[0]
    n = start.shape[0] - 1
    _check(dsum, "dsum", torch.float32, (m, N_FIELD), dev)
    _check(start, "start", torch.int32, (n + 1,), dev)
    if dsum.data_ptr() % 8:        # rows are read as five 8 B pairs
        raise ValueError("dsum is not 8-byte aligned")
    out = torch.empty(n, N_FIELD, dtype=torch.float32, device=dev)
    fn = kernel_fn("gaussian_grad_sum", "gaussian_grad_sum", 3, n_int=1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dsum.data_ptr(), start.data_ptr(), out.data_ptr(), n,
                 stream)
    if err != 0:
        raise RuntimeError(f"gaussian_grad_sum launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["gaussian_grad_sum"] += 1
    return out


# ------------------------------------------------------------- autograd

class Composite(torch.autograd.Function):
    """Differentiable compositing of binned Gaussians (the counterpart of
    ``_make_composite``'s custom_vjp). Binning stays outside: depth order
    and integer rects carry no gradient, as in the CUDA sort stage.

    Returns the (8, Hp, Wp) output; channels 0-6 are differentiable
    (T_final's cotangent is the g_T of the backward kernel)."""

    @staticmethod
    def forward(ctx, mean2d, conic, rgbz, opacity, rect16, gather_idx,
                tile_start, tile_count, sum_rank, sum_start, grid_x,
                grid_y):
        feat, rect = _records(mean2d, conic, rgbz, opacity, rect16,
                              gather_idx)
        out, keff = composite_fwd(feat, rect, tile_start, tile_count,
                                  grid_x, grid_y)
        ctx.save_for_backward(feat, rect, tile_start, tile_count, keff, out,
                              sum_rank, sum_start)
        ctx.grid = (grid_x, grid_y)
        return out

    @staticmethod
    def backward(ctx, gout):
        (feat, rect, starts, counts, keff, out, sum_rank,
         sum_start) = ctx.saved_tensors
        gx, gy = ctx.grid
        dsum = composite_bwd(feat, rect, starts, counts, keff, out,
                             gout.contiguous(), sum_rank, gx, gy)
        # per-Gaussian sum in a fixed order; padding rows are in no run
        dsrc = gaussian_grad_sum(dsum, sum_start)
        return (dsrc[:, 0:2], dsrc[:, 2:5], dsrc[:, 6:10], dsrc[:, 5],
                None, None, None, None, None, None, None, None)


# ------------------------------------------------------ the layout carry
#
# A binning layout (``TileBins``: gather_idx, tile_start, tile_count,
# num_instances, overflow, and the sum layout sum_order / sum_start /
# sum_rank) is the port's counterpart of the JAX ``BinState``
# (``raster_pallas.py:639-670``) without the fast binner's fields, which
# the port does not have. Carried across optimizer steps it
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
                               cfg.grid_x, cfg.grid_y, cfg.max_instances)
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


def rasterize(proj: ProjectedGaussians, rgbz: torch.Tensor,
              opacity: torch.Tensor, cfg: RasterConfig,
              bins: TileBins | None = None):
    """Rasterize projected Gaussians through the compositing kernels.

    rgbz: (N, 4) per-Gaussian [r, g, b, z]; opacity: (N,) in [0, 1].
    bins: a carried layout to reuse (see the layout carry above); None
    bins fresh.
    Returns {"image": (6, H, W) [r, g, b, z, sil, z^2] without background,
    "final_T": (H, W), "overflow": () instances dropped at the cap (on a
    carried layout: ``_reuse_overflow``), "num_instances": () instances in
    the layout, "bins": the layout used}.
    """
    proj_b = _prune_and_snug(proj, opacity)
    if bins is None:
        bins = _bin_state(proj_b, cfg)
        overflow = bins.overflow
    else:
        overflow = _reuse_overflow(proj_b, cfg)
    out = Composite.apply(proj_b.mean2d, proj_b.conic, rgbz, opacity,
                          proj_b.tile_rect, bins.gather_idx, bins.tile_start,
                          bins.tile_count, bins.sum_rank, bins.sum_start,
                          cfg.grid_x, cfg.grid_y)
    out = out[:, :cfg.height, :cfg.width]
    return {"image": out[0:6], "final_T": out[6], "overflow": overflow,
            "num_instances": bins.num_instances, "bins": bins}
