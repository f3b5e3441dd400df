"""The compositing-forward ablation family (``ops/raster_ablate.py``): each
variant's plain version against a per-pixel sequential walk in numpy f32,
``baseline``, ``nobulk`` and ``rowmap`` against the forward's own plain
version, and each variant's pair counts (the operation bound's input)
against the walk.
The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``'s ``ablate`` phase.

Tolerances. The walk blends in the kernels' order (front to back, one f32
add at a time); the plain version sums the same terms through cumsums and
an einsum, so channels agree to f32 reassociation: 2e-5 absolute, the
JAX package's oracle-vs-Pallas pixel gate. Stop indices and pair counts
are integers and must be equal (no pixel of these scenes lands within an
ulp of the T < 1e-4 cutoff).
"""

import numpy as np
import pytest
import torch

from freesurgs_tpu_torch.core.camera import Camera
from freesurgs_tpu_torch.ops.binning import derive_bin_rect
from freesurgs_tpu_torch.ops.projection import project_gaussians
from freesurgs_tpu_torch.ops.raster_ablate import (
    VARIANTS, ablate_pair_counts, composite_fwd_ablate)
from freesurgs_tpu_torch.ops.raster_cuda import (
    RasterConfig, _prune_and_snug, composite_fwd_plain, instance_records)

PIX_TOL = 2e-5
H, W = 40, 56


def scene(seed, saturated):
    """Projected Gaussians, rgbz and opacity as torch CPU tensors."""
    rng = np.random.default_rng(seed)
    n = 300 if not saturated else 500
    cam = Camera(height=H, width=W, fx=0.9 * W, fy=0.9 * W, cx=W / 2,
                 cy=H / 2)
    if saturated:
        # near-opaque, frame-covering Gaussians: pixels stop early
        means = np.stack([rng.uniform(-0.3, 0.3, n),
                          rng.uniform(-0.25, 0.25, n),
                          rng.uniform(0.6, 3.0, n)], -1)
        scales = np.exp(rng.uniform(-1.5, -0.5, (n, 3)))
        opac = 1 / (1 + np.exp(-rng.uniform(2.5, 4.0, n)))
    else:
        means = np.stack([rng.uniform(-0.8, 0.8, n),
                          rng.uniform(-0.6, 0.6, n),
                          rng.uniform(0.3, 3.0, n)], -1)
        scales = np.exp(rng.uniform(-3.5, -2.0, (n, 3)))
        opac = rng.uniform(0.0, 1.0, n)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    proj = project_gaussians(f32(means), f32(scales),
                             f32(rng.normal(size=(n, 4))), cam)
    rgbz = torch.cat([f32(rng.uniform(0, 1, (n, 3))), proj.depth[:, None]],
                     dim=1)
    return proj, rgbz, f32(opac)


def sequential_walk(proj, rgbz, opac, grid_x, grid_y, stop, rect_mask,
                    linear_t):
    """Per-pixel front-to-back walk over the global depth order with the
    CUDA cutoffs, over the bin-padded image: (out (8, Hp, Wp) as the
    kernels write it, blended pairs, stopping pairs). A Gaussian reaches a
    pixel when its 32 px bin rect holds the pixel's bin tile and, with
    ``rect_mask``, its 16 px rect the pixel's 16 px tile."""
    snug = _prune_and_snug(proj, opac)
    r16 = snug.tile_rect.numpy()
    r32 = derive_bin_rect(snug, 2).tile_rect.numpy()
    on = snug.tiles_touched.numpy() > 0
    depth = proj.depth.numpy()
    order = np.argsort(np.where(on, depth, np.inf), kind="stable")
    hp, wp = 32 * grid_y, 32 * grid_x
    ys, xs = np.mgrid[0:hp, 0:wp]
    px, py = xs.ravel().astype(np.float32), ys.ravel().astype(np.float32)
    tx, ty = xs.ravel() // 16, ys.ravel() // 16
    bx, by = xs.ravel() // 32, ys.ravel() // 32
    mean2d, conic = proj.mean2d.numpy(), proj.conic.numpy()
    rgbz, opac = rgbz.numpy(), opac.numpy()
    tr = np.full(hp * wp, 0.0 if not linear_t else 1.0, np.float32)
    done = np.zeros(hp * wp, bool)
    acc = np.zeros((6, hp * wp), np.float32)
    stop_idx = np.zeros(hp * wp, np.float32)
    rank = np.zeros((grid_y, grid_x), np.int64)   # slots seen per bin tile
    blended = 0
    for g in order:
        if not on[g]:
            continue
        x0, y0, x1, y1 = r32[g]
        rank[y0:y1, x0:x1] += 1
        member = (bx >= x0) & (bx < x1) & (by >= y0) & (by < y1)
        if rect_mask:
            x0, y0, x1, y1 = r16[g]
            member &= (tx >= x0) & (tx < x1) & (ty >= y0) & (ty < y1)
        mx, my = mean2d[g]
        a, b, c = conic[g]
        dx, dy = mx - px, my - py
        power = np.float32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
        raw = opac[g] * np.exp(power)
        alpha = np.minimum(raw, np.float32(0.99))
        ok = member & (power <= 0) & (raw >= np.float32(1 / 255)) & ~done
        T = tr if linear_t else np.exp(tr)
        cross = ok & (T * (np.float32(1) - alpha) < np.float32(1e-4))
        if not stop:
            cross[:] = False
        blend = ok & ~cross
        done |= cross
        blended += int(blend.sum())
        w = np.where(blend, alpha * T, np.float32(0))
        z = rgbz[g, 3]
        for ch, v in enumerate((rgbz[g, 0], rgbz[g, 1], rgbz[g, 2], z,
                                np.float32(1), z * z)):
            acc[ch] += w * v
        if linear_t:
            tr = np.where(blend, tr * (np.float32(1) - alpha), tr)
        else:
            tr = np.where(blend, tr + np.log1p(-alpha), tr)
        stop_idx = np.where(blend, rank[by, bx], stop_idx)
    T_final = tr if linear_t else np.exp(tr)
    out = np.concatenate([acc, T_final[None], stop_idx[None]]
                         ).reshape(8, hp, wp).astype(np.float32)
    return out, blended, int(done.sum())


def records(saturated):
    proj, rgbz, opac = scene(11, saturated)
    cfg = RasterConfig(H, W, 1 << 20)
    feat, rect, bins = instance_records(proj, rgbz, opac, cfg)
    return proj, rgbz, opac, cfg, feat, rect, bins


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_variant_matches_sequential_walk(variant, saturated):
    proj, rgbz, opac, cfg, feat, rect, bins = records(saturated)
    mech = VARIANTS[variant]
    out, keff = composite_fwd_ablate(variant, feat, rect, bins.tile_start,
                                     bins.tile_count, cfg.grid_x, cfg.grid_y)
    ref, _, stopping = sequential_walk(proj, rgbz, opac, cfg.grid_x,
                                       cfg.grid_y, **mech.plain())
    np.testing.assert_allclose(out[:7].numpy(), ref[:7], atol=PIX_TOL)
    np.testing.assert_array_equal(out[7].numpy(), ref[7])
    n_chunks = -(-bins.tile_count // 128)
    if mech.stop:
        assert (stopping > 0) == saturated
        assert bool((keff <= n_chunks).all())
    else:
        assert stopping == 0
        assert torch.equal(keff, n_chunks.to(torch.int32))


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("variant", ["nobulk", "rowmap"])
def test_baseline_nobulk_rowmap_are_the_forward(variant, saturated):
    """``baseline`` and the variants that change only where records and
    pixels live compute the forward's function: their plain versions (the
    wrapper on CPU tensors) equal ``composite_fwd_plain``'s output
    exactly."""
    *_, cfg, feat, rect, bins = records(saturated)
    args = (feat, rect, bins.tile_start, bins.tile_count, cfg.grid_x,
            cfg.grid_y)
    ref, keff = composite_fwd_plain(*args)
    for name in ("baseline", variant):
        out, k = composite_fwd_ablate(name, *args)
        assert torch.equal(out, ref) and torch.equal(k, keff), name


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_pair_counts_match_walk(variant, saturated):
    """Blended and stopping pairs of each variant's function equal the
    walk's; cut pairs stay within the slots the tiles hold."""
    proj, rgbz, opac, cfg, feat, rect, bins = records(saturated)
    pairs = ablate_pair_counts(variant, feat, rect, bins.tile_start,
                               bins.tile_count, cfg.grid_x)
    _, blended, stopping = sequential_walk(proj, rgbz, opac, cfg.grid_x,
                                           cfg.grid_y,
                                           **VARIANTS[variant].plain())
    assert (pairs["blended"], pairs["stopping"]) == (blended, stopping)
    slots = int(bins.tile_count.sum()) * 32 * 32
    assert 0 < sum(pairs.values()) <= slots


def test_unknown_variant_raises():
    *_, cfg, feat, rect, bins = records(False)
    with pytest.raises(ValueError, match="unknown ablation variant"):
        composite_fwd_ablate("nodma", feat, rect, bins.tile_start,
                             bins.tile_count, cfg.grid_x, cfg.grid_y)
