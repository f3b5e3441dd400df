"""The port's binned compositing (``rasterize``: binning + ``Composite``, which
runs the plain versions of the CUDA kernels on a CPU tensor) against the JAX
package: ``rasterize_pallas`` in interpret mode at one tiny size, and the
dense ``rasterize_oracle`` elsewhere.

Tolerances are the JAX package's own oracle-vs-Pallas gate
(BASELINE.md): pixels within 2e-5 absolute, and gradients within 5e-5
after normalizing each by its largest magnitude. Both sides sum the same
terms in another order (per-tile cumsums against a global one), so they
agree to f32 reassociation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.ops.oracle import rasterize_oracle
from freesurgs_tpu.ops.projection import project_gaussians as jproj
from freesurgs_tpu.ops.raster_pallas import RasterConfig as JRC, \
    rasterize_pallas
from freesurgs_tpu.ops.oracle import composite_order_weights as jweights
from freesurgs_tpu_torch.ops.oracle import composite_order_weights as \
    tweights, rasterize_oracle as t_oracle
from freesurgs_tpu_torch.ops.projection import ProjectedGaussians
from freesurgs_tpu_torch.ops.binning import sum_layout
from freesurgs_tpu_torch.ops.raster_cuda import RasterConfig, \
    _prune_and_snug, _records, composite_bwd_plain, composite_fwd_plain, \
    composite_pair_counts, gaussian_grad_sum, gaussian_grad_sum_plain, \
    instance_records, rasterize

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

PIX_TOL = 2e-5
GRAD_TOL = 5e-5


def scene(n, H, W, seed, saturated=False):
    rng = np.random.default_rng(seed)
    cam = JCam(height=H, width=W, fx=0.9 * W, fy=0.9 * W, cx=W / 2,
               cy=H / 2)
    if saturated:
        # a deck of near-opaque, frame-covering Gaussians: every pixel
        # crosses T < 1e-4 within the first chunks (early termination)
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
    quats = rng.normal(size=(n, 4))
    proj = jproj(jnp.asarray(means, jnp.float32),
                 jnp.asarray(scales, jnp.float32),
                 jnp.asarray(quats, jnp.float32), cam)
    rgbz = np.concatenate([rng.uniform(0, 1, (n, 3)),
                           np.asarray(proj.depth)[:, None]], 1)
    return (cam, proj, rgbz.astype(np.float32), opac.astype(np.float32),
            rng.normal(size=(6, H, W)).astype(np.float32),
            rng.normal(size=(H, W)).astype(np.float32))


def jax_oracle(cam, proj):
    def f(mean2d, conic, rgbz, opac):
        z = rgbz[:, 3:4]
        cols = jnp.concatenate([rgbz, jnp.ones_like(z), z * z], 1)
        out = rasterize_oracle(proj._replace(mean2d=mean2d, conic=conic),
                               cols, opac, cam.height, cam.width,
                               jnp.zeros(6))
        return out["image"], out["final_T"]
    return f


def port(cam, proj, max_instances=1 << 20):
    cfg = RasterConfig(cam.height, cam.width, max_instances)

    def f(mean2d, conic, rgbz, opac):
        p = ProjectedGaussians(mean2d, conic,
                               *(torch.tensor(np.asarray(x))
                                 for x in proj[2:]))
        out = rasterize(p, rgbz, opac, cfg)
        return out["image"], out["final_T"], out["overflow"]
    return f


def compare(jf, tf, proj, rgbz, opac, g_img, g_T):
    args = (np.asarray(proj.mean2d), np.asarray(proj.conic), rgbz, opac)
    # under jit: one compile instead of one dispatch a primitive
    (ji, jT), vjp = jax.vjp(jax.jit(jf), *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ti, tT, overflow = tf(*ts)
    assert int(overflow) == 0
    np.testing.assert_allclose(np.asarray(ji), ti.detach().numpy(),
                               atol=PIX_TOL)
    np.testing.assert_allclose(np.asarray(jT), tT.detach().numpy(),
                               atol=PIX_TOL)
    jg = vjp((jnp.asarray(g_img), jnp.asarray(g_T)))
    tg = torch.autograd.grad((ti, tT), ts,
                             (torch.tensor(g_img), torch.tensor(g_T)))
    for name, a, b in zip(("mean2d", "conic", "rgbz", "opacity"), jg, tg):
        a, b = np.asarray(a), b.numpy()
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_TOL,
                                   err_msg=name)
    return np.asarray(jT)


def test_matches_pallas_interpret():
    """The JAX kernels themselves (interpret mode) at 64x64."""
    cam, proj, rgbz, opac, g_img, g_T = scene(300, 64, 64, 0)

    def jf(mean2d, conic, rgbz, opac):
        cfg = JRC(height=64, width=64, max_instances=8192, interpret=True,
                  bin_tile=32)
        out = rasterize_pallas(proj._replace(mean2d=mean2d, conic=conic),
                               rgbz, opac, cfg)
        return out["image"], out["final_T"]

    compare(jf, port(cam, proj), proj, rgbz, opac, g_img, g_T)


@pytest.mark.parametrize("H,W,n", [(64, 96, 400), (40, 56, 300),
                                   (33, 70, 250)])
def test_forward_and_vjp_vs_oracle(H, W, n):
    """Image sizes that are and are not multiples of the 32 px bin."""
    cam, proj, rgbz, opac, g_img, g_T = scene(n, H, W, H + W)
    compare(jax_oracle(cam, proj), port(cam, proj), proj, rgbz, opac,
            g_img, g_T)


def test_saturated_early_termination():
    cam, proj, rgbz, opac, g_img, g_T = scene(600, 48, 64, 7, saturated=True)
    final_T = compare(jax_oracle(cam, proj), port(cam, proj), proj, rgbz,
                      opac, g_img, g_T)
    assert np.median(final_T) < 1e-3     # saturation really happened


def test_overflow_reported_at_cap():
    cam, proj, rgbz, opac, *_ = scene(400, 64, 96, 3)
    args = [torch.tensor(np.asarray(a)) for a in
            (proj.mean2d, proj.conic, rgbz, opac)]
    _, _, overflow = port(cam, proj, max_instances=256)(*args)
    assert int(overflow) > 0


def check_sum_layout(gidx, order, start, rank, n):
    """``sum_layout``'s contract: the runs hold each Gaussian's slots in
    ascending slot order, padding (index n) sorts last, from start[n] on,
    and sum_rank is the inverse of sum_order."""
    m = gidx.shape[0]
    held = gidx[order.long()]
    assert torch.equal(held, torch.sort(gidx).values)
    same = held[1:] == held[:-1]
    assert bool((order[1:] > order[:-1])[same].all())   # slot order in a run
    assert bool((held[:int(start[n])] < n).all())
    assert bool((held[int(start[n]):] == n).all())
    assert torch.equal(rank[order.long()], torch.arange(m, dtype=torch.int32))
    assert bool((rank[gidx == n] >= start[n]).all())


def test_fixed_order_gaussian_sum():
    """The per-Gaussian gradient sum after K2 (``gaussian_grad_sum``'s
    plain version over the sum-ordered rows K2 writes, slot s in row
    ``sum_rank[s]``): bitwise the CPU's ``index_add_`` over ``gather_idx``
    (which adds each Gaussian's slots in ascending slot order, as the
    kernel does), on a real layout with padding slots and on a random map
    with empty and long runs; the layouts checked by ``check_sum_layout``.
    Then a render on that layout carried with moved means (``rasterize(
    bins=)``): its per-Gaussian gradients bitwise ``index_add_`` of the
    plain backward's rows, put back in slot order by ``sum_rank``."""
    cam, proj, rgbz, opac, g_img, g_T = scene(400, 64, 96, 3)
    p = ProjectedGaussians(*(torch.tensor(np.asarray(x)) for x in proj))
    cfg = RasterConfig(64, 96, 1 << 20)
    rgbz_t, opac_t = torch.tensor(rgbz), torch.tensor(opac)
    feat, rect, bins = instance_records(p, rgbz_t, opac_t, cfg)
    n = 400
    rng = np.random.default_rng(5)
    gidx_rand = torch.tensor(rng.integers(0, n + 1, 3000))
    for gidx, order, start, rank in (
            (bins.gather_idx, bins.sum_order, bins.sum_start,
             bins.sum_rank),
            (gidx_rand,) + sum_layout(gidx_rand, n)):
        assert int((gidx == n).sum()) > 0              # padding present
        check_sum_layout(gidx, order, start, rank, n)
        d = torch.tensor(rng.normal(size=(10, gidx.shape[0])),
                         dtype=torch.float32)
        dsum = torch.empty(gidx.shape[0], 10)
        dsum[rank] = d.T
        want = torch.zeros(n + 1, 10).index_add_(0, gidx, d.T)[:n]
        assert torch.equal(gaussian_grad_sum(dsum, start), want)

    moved = p._replace(mean2d=p.mean2d + 0.25)
    leaves = [x.clone().requires_grad_(True)
              for x in (moved.mean2d, moved.conic, rgbz_t, opac_t)]
    out = rasterize(moved._replace(mean2d=leaves[0], conic=leaves[1]),
                    leaves[2], leaves[3], cfg, bins=bins)
    assert out["bins"] is bins
    got = torch.autograd.grad((out["image"], out["final_T"]), leaves,
                              (torch.tensor(g_img), torch.tensor(g_T)))
    proj_b = _prune_and_snug(moved, opac_t)
    feat, rect = _records(proj_b.mean2d, proj_b.conic, rgbz_t, opac_t,
                          proj_b.tile_rect, bins.gather_idx)
    gout = torch.zeros(8, cfg.grid_y * 32, cfg.grid_x * 32)
    gout[0:6, :64, :96] = torch.tensor(g_img)
    gout[6, :64, :96] = torch.tensor(g_T)
    dsum = composite_bwd_plain(feat, rect, bins.tile_start,
                               bins.tile_count, gout, bins.sum_rank,
                               cfg.grid_x, cfg.grid_y)
    want = torch.zeros(n + 1, 10).index_add_(
        0, bins.gather_idx, dsum[bins.sum_rank.long()])[:n]
    for a, b in zip(got, (want[:, 0:2], want[:, 2:5], want[:, 6:10],
                          want[:, 5])):
        assert torch.equal(a, b)


def test_port_oracle_matches_jax_oracle():
    """The port's dense oracle (the test reference of its own render) and
    its closed-form weights against JAX's."""
    cam, proj, rgbz, opac, g_img, g_T = scene(200, 40, 56, 9)
    z = rgbz[:, 3:4]
    cols = np.concatenate([rgbz, np.ones_like(z), z * z], 1)
    bg = np.linspace(0.2, 1.0, 6).astype(np.float32)
    j = rasterize_oracle(proj, jnp.asarray(cols), jnp.asarray(opac), 40, 56,
                         jnp.asarray(bg))
    t = t_oracle(ProjectedGaussians(*(torch.tensor(np.asarray(x))
                                      for x in proj)),
                 torch.tensor(cols), torch.tensor(opac), 40, 56,
                 torch.tensor(bg))
    for k in ("image", "final_T"):
        np.testing.assert_allclose(np.asarray(j[k]), t[k].numpy(),
                                   atol=PIX_TOL)
    abar = np.clip(np.random.default_rng(1).uniform(-0.3, 0.99, (50, 30)),
                   0, None).astype(np.float32)
    for a, b in zip(jweights(jnp.asarray(abar)),
                    tweights(torch.tensor(abar))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)


def sequential_pairs(proj, opac, H, W):
    """Blended and stopping (instance, pixel) pairs of a per-pixel sequential
    front-to-back walk in numpy f32 over the global depth order, with the
    CUDA cutoffs and the log-space transmittance of the kernels. H, W are
    the bin-padded sizes: the kernels composite the padding pixels too."""
    radius = np.asarray(proj.radius)
    order = np.argsort(np.where(radius > 0, np.asarray(proj.depth), np.inf),
                       kind="stable")
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = xs.ravel().astype(np.float32), ys.ravel().astype(np.float32)
    tx, ty = xs.ravel() // 16, ys.ravel() // 16
    logT = np.zeros(H * W, np.float32)
    done = np.zeros(H * W, bool)
    blended = 0
    for g in order:
        if radius[g] <= 0:
            continue
        mx, my = np.asarray(proj.mean2d[g])
        a, b, c = np.asarray(proj.conic[g])
        x0, y0, x1, y1 = np.asarray(proj.tile_rect[g])
        dx, dy = mx - px, my - py
        power = np.float32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
        raw = opac[g] * np.exp(power)
        alpha = np.minimum(raw, np.float32(0.99))
        ok = ((power <= 0) & (raw >= np.float32(1 / 255)) & ~done
              & (tx >= x0) & (tx < x1) & (ty >= y0) & (ty < y1))
        T = np.exp(logT)
        cross = ok & (T * (np.float32(1) - alpha) < np.float32(1e-4))
        blend = ok & ~cross
        done |= cross
        blended += int(blend.sum())
        logT = np.where(blend, logT + np.log1p(-alpha), logT)
    return blended, int(done.sum())


@pytest.mark.parametrize("saturated", [False, True])
def test_pair_counts_match_sequential_walk(saturated):
    """The pair counts behind the kernels' operation bound: blended and
    stopping pairs equal a per-pixel sequential walk (integer counts,
    exact); cut pairs are at most the pixel slots the tiles hold."""
    H, W = 40, 56
    cam, proj, rgbz, opac, *_ = scene(300, H, W, 11, saturated=saturated)
    tproj = ProjectedGaussians(*(torch.tensor(np.asarray(x)) for x in proj))
    cfg = RasterConfig(H, W, 1 << 20)
    feat, rect, bins = instance_records(tproj, torch.tensor(rgbz),
                                        torch.tensor(opac), cfg)
    pairs = composite_pair_counts(feat, rect, bins.tile_start,
                                  bins.tile_count, cfg.grid_x)
    blended, stopping = sequential_pairs(proj, opac, 32 * cfg.grid_y,
                                         32 * cfg.grid_x)
    assert blended > 0 and (stopping > 0) == saturated
    assert (pairs["blended"], pairs["stopping"]) == (blended, stopping)
    slots = int(bins.tile_count.sum()) * 32 * 32
    assert 0 < sum(pairs.values()) <= slots


# ---------------------------------------------------------------------------
# A numpy mirror of the backward kernel's arithmetic (csrc/composite_bwd.cu)

LANE = np.arange(32)
F32 = np.float32


def reduce_scatter10(v):
    """The kernel's transposing butterfly over the 32 lanes of each warp:
    v (W, 32, 10) f32 -> (W, 32), lane l holding the total of field
    scatter_field(l) (or duplicating a partner's)."""
    b4, b3, b2, b1 = ((LANE & m) > 0 for m in (16, 8, 4, 2))

    def shfl(x, m):
        return x[:, LANE ^ m]

    a = [np.where(b4, v[..., 5 + i], v[..., i])
         + shfl(np.where(b4, v[..., i], v[..., 5 + i]), 16) for i in range(5)]
    c = [np.where(b3, a[3 + s], a[s]) + shfl(np.where(b3, a[s], a[3 + s]), 8)
         for s in range(2)]
    c.append(a[2] + shfl(a[2], 8))
    send1 = np.where(b2, c[0], np.where(b3, c[1], c[2]))
    keep1 = np.where(b2, np.where(b3, c[1], c[2]), c[0])
    d0 = keep1 + shfl(send1, 4)
    d1 = c[1] + shfl(c[1], 4)
    split = ~b3 & ~b2
    e = np.where(split & b1, d1, d0) + shfl(np.where(split & ~b1, d1, d0), 2)
    return e + shfl(e, 1)


def scatter_field(lane):
    if lane & 1:
        return -1
    g = 5 * ((lane >> 4) & 1)
    b3, b2, b1 = (lane >> 3) & 1, (lane >> 2) & 1, (lane >> 1) & 1
    if not b3 and not b2:
        return g + b1
    if b1:
        return -1
    return g + 2 + (1 + b2 if b3 else 0)


WRITERS = [(lane, scatter_field(lane)) for lane in range(32)
           if scatter_field(lane) >= 0]


def test_reduce_scatter10_sums_every_field_once():
    v = np.random.default_rng(0).normal(size=(8, 32, 10)).astype(F32)
    out = reduce_scatter10(v)
    assert sorted(f for _, f in WRITERS) == list(range(10))
    for lane, f in WRITERS:
        np.testing.assert_allclose(out[:, lane], v[..., f].sum(axis=1),
                                   rtol=1e-5, atol=1e-5)


def bwd_mirror(feat, rect, starts, counts, out, gout, grid_x):
    """composite_bwd.cu in numpy f32: per tile, each warp's 128 pixels of
    one 16 px quadrant; the replay of slot i at a pixel only when i is
    below the forward's stop index (out[7]) and the alpha cutoffs pass
    (power rounded op by op); T carried as a running product; each lane's
    sums over its 4 pixels in order, the chain's geometric terms from
    P, Q, U; the 12-shuffle butterfly; then the sum over warps in warp
    order of those whose quadrant the rect covers, before their last
    stop. Returns dfeat (10, M), zero on slots no replay reaches."""
    feat = feat.numpy().astype(F32)
    rect = rect.numpy()
    out, gout = out.numpy(), gout.numpy()
    dfeat = np.zeros_like(feat)
    w_ = np.arange(8)[:, None, None]
    q = w_ >> 1
    k_ = np.arange(4)[None, None, :]
    lane = LANE[None, :, None]
    for tile, (start, count) in enumerate(zip(starts.tolist(),
                                              counts.tolist())):
        if count == 0:
            continue
        ty, tx = divmod(tile, grid_x)
        x = tx * 32 + (q & 1) * 16 + lane % 16 + 0 * k_        # (8, 32, 4)
        y = ty * 32 + (q >> 1) * 16 + (w_ & 1) * 8 + lane // 16 + 2 * k_
        fx, fy = x.astype(F32), y.astype(F32)
        x16, y16 = x[:, 0, 0] >> 4, y[:, 0, 0] >> 4                # per warp
        g = gout[0:6, y, x]                                         # (6, ...)
        t0 = F32(0)
        for ch in range(6):
            t0 = t0 + g[ch] * out[ch, y, x]
        R = t0 + gout[6, y, x] * out[6, y, x]
        stop = out[7, y, x].astype(np.int64)
        smax = stop.reshape(8, -1).max(axis=1)
        T = np.ones_like(R)
        S = np.zeros_like(R)
        for i in range(min(count, int(smax.max()))):
            mx, my, ca, cb, cc, op, cr, cgr, cbl, z = feat[:, start + i]
            rc = int(rect[start + i])
            hit = ((x16 >= (rc & 0xFF)) & (x16 < ((rc >> 16) & 0xFF))
                   & (y16 >= ((rc >> 8) & 0xFF)) & (y16 < ((rc >> 24) & 0xFF))
                   & (i < smax))
            if not hit.any():
                continue
            dx = mx - fx
            dxx_a, dx_b = (ca * dx) * dx, cb * dx
            dy = my - fy
            power = F32(-0.5) * (dxx_a + (cc * dy) * dy) - dx_b * dy
            with np.errstate(over="ignore"):
                expp = np.exp(power)
            raw = op * expp
            ok = ((i < stop) & (power <= 0) & (raw >= F32(1 / 255))
                  & hit[:, None, None])
            alpha = np.minimum(raw, F32(0.99))
            w = alpha * T
            cg = (g[0] * cr + g[1] * cgr + g[2] * cbl + g[3] * z + g[4]
                  + g[5] * (z * z))
            S = np.where(ok, S + w * cg, S)
            om = F32(1) - alpha
            dalpha = cg * T - (R - S) / om
            dclamp = np.where(raw < F32(0.99), dalpha, F32(0))
            dpow = dclamp * op * expp
            terms = (dpow, dy * dpow, dy * (dy * dpow), dclamp * expp,
                     g[0] * w, g[1] * w, g[2] * w,
                     (g[3] + F32(2) * z * g[5]) * w)
            acc = np.zeros((8,) + dx.shape[:2], F32)
            for k in range(4):                    # each lane's pixels in order
                acc = acc + np.where(ok[..., k], np.stack(
                    [t[..., k] for t in terms]), F32(0))
            T = np.where(ok, T * om, T)
            P, Q, U = acc[0], acc[1], acc[2]
            dx0 = dx[..., 0]
            v = np.stack([-((ca * dx0) * P + cb * Q), -(cc * Q + (cb * dx0) * P),
                          (F32(-0.5) * dx0 * dx0) * P, -dx0 * Q,
                          F32(-0.5) * U, *acc[3:]], axis=-1)    # (8, 32, 10)
            any_ = ok.any(axis=(1, 2))
            red = np.where(any_[:, None], reduce_scatter10(v), F32(0))
            part = np.zeros((8, 10), F32)
            for ln, f in WRITERS:
                part[:, f] = red[:, ln]
            s = np.zeros(10, F32)
            for wi in range(8):                   # warp order
                if hit[wi]:
                    s = s + part[wi]
            dfeat[:, start + i] = s
    return dfeat


@pytest.mark.parametrize("saturated", [False, True])
def test_bwd_replay_mirror(saturated):
    """The backward kernel's arithmetic (the numpy mirror above), on the
    records and forward output of a binned scene, against
    ``composite_bwd_plain`` (autograd through the log-space forward; its
    sum-ordered rows put back in slot order by ``sum_rank``) per slot, and
    against the JAX oracle's VJP per Gaussian, as is the plain backward
    through ``gaussian_grad_sum_plain``: all within 5e-5
    after normalizing each field by its largest magnitude (the kernels'
    gradient gate). The running-product T and the regrouped sums move the
    result by f32 rounding only; the saturated scene has pixels that stop,
    so the replay's bound by the stop index is live."""
    H, W = 40, 56
    cam, proj, rgbz, opac, g_img, g_T = scene(300 if saturated else 250, H,
                                              W, 13, saturated=saturated)
    tproj = ProjectedGaussians(*(torch.tensor(np.asarray(x)) for x in proj))
    cfg = RasterConfig(H, W, 1 << 20)
    feat, rect, bins = instance_records(tproj, torch.tensor(rgbz),
                                        torch.tensor(opac), cfg)
    gx, gy = cfg.grid_x, cfg.grid_y
    out, _ = composite_fwd_plain(feat, rect, bins.tile_start,
                                 bins.tile_count, gx, gy)
    stopping = composite_pair_counts(feat, rect, bins.tile_start,
                                     bins.tile_count, gx)["stopping"]
    assert (stopping > 0) == saturated and int(out[7].max()) > 0
    gout = torch.zeros_like(out)
    gout[0:6, :H, :W] = torch.tensor(g_img)
    gout[6, :H, :W] = torch.tensor(g_T)
    mirror = bwd_mirror(feat, rect, bins.tile_start, bins.tile_count, out,
                        gout, gx)
    dsum = composite_bwd_plain(feat, rect, bins.tile_start,
                               bins.tile_count, gout, bins.sum_rank, gx, gy)
    plain = dsum[bins.sum_rank.long()].T.numpy()   # back to slot order
    for f in range(10):
        scale = max(np.abs(plain[f]).max(), 1e-12)
        np.testing.assert_allclose(mirror[f] / scale, plain[f] / scale,
                                   atol=GRAD_TOL, err_msg=f"field {f}")

    n = proj.mean2d.shape[0]
    per_g = np.zeros((n + 1, 10), F32)
    np.add.at(per_g, bins.gather_idx.numpy(), mirror.T)
    args = (np.asarray(proj.mean2d), np.asarray(proj.conic), rgbz, opac)
    _, vjp = jax.vjp(jax_oracle(cam, proj), *map(jnp.asarray, args))
    jg = vjp((jnp.asarray(g_img), jnp.asarray(g_T)))
    # the mirror's per-slot gradients summed per Gaussian, and the plain
    # backward's sum-ordered rows through the fixed-order sum
    for per in (per_g[:n],
                gaussian_grad_sum_plain(dsum, bins.sum_start).numpy()):
        for name, a, b in zip(("mean2d", "conic", "rgbz", "opacity"), jg,
                              (per[:, 0:2], per[:, 2:5], per[:, 6:10],
                               per[:, 5])):
            a = np.asarray(a)
            scale = max(np.abs(a).max(), 1e-12)
            np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_TOL,
                                       err_msg=name)
