"""The port's binning against the JAX binners: snug + prune rects, and the
instance layout (gather_idx, tile_start, tile_count), which must be EQUAL
to ``build_tile_bins`` and ``build_tile_bins_fast`` at the same capacity —
including the overflow count when a cap binds. Integer outputs: no
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.ops import binning, binning_fast, projection, \
    raster_pallas
from freesurgs_tpu_torch.ops.binning import CHUNK, build_tile_bins, \
    derive_bin_rect
from freesurgs_tpu_torch.ops.projection import ProjectedGaussians
from freesurgs_tpu_torch.ops.raster_cuda import _prune_and_snug, \
    effective_bin_tiles

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

# The JAX functions under jit: one compile a shape instead of one
# op-by-op dispatch a primitive (same functions, integer outputs).
jbins = jax.jit(binning.build_tile_bins, static_argnums=(1, 2, 3))
jderive = jax.jit(binning.derive_bin_rect, static_argnums=1)
jfast = jax.jit(binning_fast.build_tile_bins_fast, static_argnums=(1, 2, 3))
jproj = jax.jit(projection.project_gaussians, static_argnums=3)
jsnug = jax.jit(raster_pallas._prune_and_snug)
jeff = jax.jit(raster_pallas.effective_bin_tiles, static_argnums=2)

CAM = JCam(height=72, width=100, fx=80.0, fy=80.0, cx=50.0, cy=36.0)
GX, GY = -(-CAM.width // 32), -(-CAM.height // 32)


def make(n, seed, degenerate=False, cam=CAM, log_scale=(-4.5, -1.5)):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.7, 0.7, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(0.15, 3.0, n)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(*log_scale, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, n).astype(np.float32)
    opac[:5] = 0.002                       # below 1/255: pre-pruned
    proj = jproj(jnp.asarray(means), jnp.asarray(scales),
                 jnp.asarray(quats), cam)
    if degenerate:
        # a conic whose det cancels to <= 0 hits the 1e-24 floor: the snug
        # box explodes and must be clipped before the int cast
        vis = np.flatnonzero(np.asarray(proj.radius) > 0)[:3]
        conic = np.asarray(proj.conic).copy()
        conic[vis] = [1.0, 1.0, 1.0]
        proj = proj._replace(conic=jnp.asarray(conic))
    return proj, opac


def to_torch(p):
    return ProjectedGaussians(*(torch.tensor(np.asarray(x)) for x in p))


def eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("degenerate", [False, True])
def test_prune_and_snug_rects(degenerate):
    proj, opac = make(400, 1, degenerate)
    j = jsnug(proj, jnp.asarray(opac))
    t = _prune_and_snug(to_torch(proj), torch.tensor(opac))
    for name in ("tile_rect", "tiles_touched", "radius"):
        eq(getattr(j, name), getattr(t, name))
    eq(jeff(proj, jnp.asarray(opac), 2),
       effective_bin_tiles(to_torch(proj), torch.tensor(opac), 2))
    eq(jderive(j, 2).tile_rect, derive_bin_rect(t, 2).tile_rect)


@pytest.mark.parametrize("n,seed", [(7, 0), (60, 1), (400, 2), (1500, 3)])
def test_layout_equals_jax_binners(n, seed):
    proj, opac = make(n, seed)
    jb = jderive(jsnug(proj, jnp.asarray(opac)), 2)
    tb = derive_bin_rect(_prune_and_snug(to_torch(proj), torch.tensor(opac)),
                         2)
    t = build_tile_bins(tb, GX, GY, 1 << 20)
    m = t.gather_idx.shape[0]
    assert m % CHUNK == 0 and int(t.overflow) == 0
    for ref in (jbins(jb, GX, GY, max(m, CHUNK)),
                jfast(jb, GX, GY, max(m, CHUNK))):
        eq(ref.gather_idx[:m], t.gather_idx)
        eq(ref.tile_start, t.tile_start)
        eq(ref.tile_count, t.tile_count)
        assert int(ref.num_instances) == int(t.num_instances)
        assert int(ref.overflow) == 0


def test_layout_equals_fast_binner_full_width():
    """The full-res recipe's 1280x1024 camera (1,280 tiles of 32 px) and
    6,000 Gaussians, nearly six of the fast binner's S1 = 1024 blocks: the
    layout equals ``build_tile_bins_fast``'s (the binner the TPU ran)
    exactly."""
    cam = JCam(height=1024, width=1280, fx=1000.0, fy=1000.0, cx=640.0,
               cy=512.0)
    gx, gy = -(-cam.width // 32), -(-cam.height // 32)
    assert gx * gy >= 1000
    proj, opac = make(6000, 5, cam=cam, log_scale=(-6.0, -3.5))
    jb = jderive(jsnug(proj, jnp.asarray(opac)), 2)
    tb = derive_bin_rect(_prune_and_snug(to_torch(proj), torch.tensor(opac)),
                         2)
    t = build_tile_bins(tb, gx, gy, 1 << 22)
    m = t.gather_idx.shape[0]
    assert m % CHUNK == 0 and int(t.overflow) == 0
    assert int(t.num_instances) > 6000
    ref = jfast(jb, gx, gy, m)
    eq(ref.gather_idx, t.gather_idx)
    eq(ref.tile_start, t.tile_start)
    eq(ref.tile_count, t.tile_count)
    assert int(ref.num_instances) == int(t.num_instances)
    assert int(ref.overflow) == 0


@pytest.mark.parametrize("cap", [128, 512, 1000])
def test_overflow_at_cap(cap):
    """With the cap binding, the port allocates the cap (rounded down to
    CHUNK) and drops the same instances as the JAX binner there."""
    proj, opac = make(900, 4)
    jb = jderive(jsnug(proj, jnp.asarray(opac)), 2)
    tb = derive_bin_rect(_prune_and_snug(to_torch(proj), torch.tensor(opac)),
                         2)
    t = build_tile_bins(tb, GX, GY, cap)
    m = (cap // CHUNK) * CHUNK
    assert t.gather_idx.shape[0] == m
    assert int(t.overflow) > 0
    for ref in (jbins(jb, GX, GY, m), jfast(jb, GX, GY, m)):
        eq(ref.gather_idx, t.gather_idx)
        eq(ref.tile_start, t.tile_start)
        eq(ref.tile_count, t.tile_count)
        assert int(ref.num_instances) == int(t.num_instances)
        assert int(ref.overflow) == int(t.overflow)
