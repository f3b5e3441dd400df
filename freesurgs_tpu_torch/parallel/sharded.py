"""Band-sharded rendering and training (port of
``freesurgs_tpu/parallel/sharded.py``).

SPMD over the ranks of a mesh's ``tiles`` group (``parallel/mesh.py``):
every rank holds the whole field and renders one band of
``band_h = pad_height_for(cam, n).height / n`` rows of the image, in three
steps:

1. the per-Gaussian stage (world->camera, EWA projection, SH) on the
   replicated field, or, with ``shard_projection``, on the rank's chunk of
   the N Gaussians with an all-gather of the projected records;
2. the records shifted and clipped to the band (``_clip_to_band``);
3. binning and compositing of the band by ``ops/raster_cuda.rasterize``:
   K1 / K2 / the per-Gaussian sum on a CUDA tensor, their plain versions on
   a CPU tensor, with the caller's instance cap divided over the bands.

JAX's shard_map turns the transpose of a replicated input into a psum of
the bands' gradients. Under ``grad_sum="direct"`` (the default) the
backward continues the per-Gaussian sum from band to band instead
(``_band_sum``): band b seeds its sums of K2's rows with band b-1's result
and hands its own to band b+1, and the last band's sums, the whole
image's, go to every rank. The bands' rows come in
the single image's slot order (its tile rows in order). When the band
height is a multiple of the kernels' 32 px bin, K1 and K2 also give each
pixel and slot the single render's values bit for bit (shifting a mean by
the band's offset y0 is exact for a mean at row y0 / 2 or further down),
so on the card the gradient of the (N, 10) records (mean2d, conic,
opacity, rgb, z) is the single-process one, bit for bit, and band-sharded
training repeats single-process training. A psum of per-band sums differs
in the last bits on Gaussians that straddle bands, and Adam and densify
amplify that (on the H100, a 1280x1024 Trainer on 2 bands drifted by 5e-5
in the loss within 30 iterations and then densified other Gaussians).

Under ``grad_sum="prefix"`` the bands do as JAX's do: each band bins with
pre-slots and reduces K2's rows by ``gaussian_grad_prefix`` over its own
layout (the prefix sum of the band's instances in depth order), and one
all-reduce over the tiles group adds the bands' (n, 10) sums, JAX's psum.
That is not bitwise the single-process "prefix" render: each band's
layout has a prefix sum of its own, so the two differ by those sums'
rounding, as JAX's bands differ from its single render. The
parameters, the pose and ``probe2d`` get their gradient from ordinary
autograd upstream of the records, the same on every rank. The collectives
are autograd functions:

- ``_GatherBands`` all-gathers each rank's (7, band_h, W) band (six
  channels and T_final; the band's overflow and instance count ride in the
  same collective) into the padded image. Every rank computes the same loss
  on that image, so its gradient is already the same everywhere: the
  backward keeps this rank's rows and communicates nothing
  (``torch.distributed.nn``'s all_gather sums in its backward, which would
  scale every gradient by n);
- under ``shard_projection``, ``_ScatterInputs`` hands each rank its chunk
  of the parameters and all-reduces the chunks' gradients, each at its
  rows, with the pose's (JAX's psum of replicated inputs; the pose's
  gradient is then a sum of per-chunk sums), and ``_GatherRecords``
  all-gathers the chunks' records; its backward keeps this rank's chunk of
  the records' gradient, which ``_band_sum`` gave every rank whole.

The collectives return the same bits on every rank, so ranks that start
equal stay bitwise equal across a run.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..ops.binning import CHUNK
from ..ops.projection import TILE, ProjectedGaussians
from ..ops.raster_cuda import (N_FIELD, RasterConfig, gaussian_grad_sum,
                               rasterize)
from ..ops.render import DEFAULT_MAX_INSTANCES, _raster_inputs
from .mesh import (TILE_AXIS, Mesh, all_gather_cat, all_reduce_sum,
                   broadcast, recv, send)

# N from which shard_projection="auto" shards the per-Gaussian stage: below
# it, projection and SH cost less than the all-gather of the records they
# save (the JAX package's threshold).
SHARD_PROJECTION_MIN_N = 1 << 18


def pad_height_for(cam: Camera, n_shards: int) -> Camera:
    """Pad image height so the tile-row grid divides evenly into bands."""
    grid_y = -(-cam.height // TILE)
    grid_y = -(-grid_y // n_shards) * n_shards
    return dataclasses.replace(cam, height=grid_y * TILE)


def band_instance_cap(max_instances: int, n_shards: int) -> int:
    """Each band's instance cap: the caller's divided over the bands, in
    whole CHUNKs (JAX ``sharded.py:64``)."""
    return max(-(-max_instances // n_shards // CHUNK) * CHUNK, CHUNK)


def _clip_to_band(b: int, band_h: int, grid_ty_band: int, mean2d, rect,
                  touched, radius):
    """Shift projected records into band ``b``'s local pixel/tile frame."""
    mean2d = mean2d - mean2d.new_tensor([0.0, float(b * band_h)])
    ty0 = torch.clamp(rect[:, 1] - b * grid_ty_band, 0, grid_ty_band)
    ty1 = torch.clamp(rect[:, 3] - b * grid_ty_band, 0, grid_ty_band)
    rect = torch.stack([rect[:, 0], ty0, rect[:, 2], ty1], dim=1)
    touched = ((rect[:, 2] - rect[:, 0]) * (ty1 - ty0)).to(torch.int32)
    radius = torch.where(touched > 0, radius, torch.zeros_like(radius))
    return mean2d, rect, touched, radius


def _band_sum(group, grad_sum: str):
    """The backward's per-Gaussian sum for this rank's band of ``group``
    (``rasterize``'s ``band_sum``), so that every rank returns the whole
    image's sums: under "direct" the bands above it continued, then the
    last band's sums broadcast; under "prefix" the bands' own prefix
    reductions all-reduced."""
    if grad_sum == "prefix":
        return lambda part: all_reduce_sum(part, group)
    r, n = dist.get_rank(group), dist.get_world_size(group)

    def grad_sum(dsum, start):
        seed = None
        if r > 0:
            seed = recv(dsum.new_empty(start.shape[0] - 1, N_FIELD), r - 1,
                        group)
        part = gaussian_grad_sum(dsum, start, init=seed)
        if r < n - 1:
            send(part, r + 1, group)
        return broadcast(part, n - 1, group)

    return grad_sum


class _GatherBands(torch.autograd.Function):
    """(7, band_h, W) band + its () overflow and instance count -> the
    (7, n band_h, W) image and the (n, 2) int32 counts, in one all-gather;
    the backward returns this rank's rows of the image's gradient."""

    @staticmethod
    def forward(ctx, band, overflow, num_instances, group):
        n = dist.get_world_size(group)
        ctx.rows = dist.get_rank(group) * band.shape[1], band.shape[1]
        # the counts' int32 bits ride as two f32 words (copied, not summed)
        counts = torch.stack([overflow, num_instances]).to(
            device=band.device, dtype=torch.int32).view(torch.float32)
        flat = all_gather_cat(torch.cat([band.reshape(-1), counts]), group)
        flat = flat.view(n, -1)
        image = flat[:, :-2].reshape((n,) + tuple(band.shape))
        image = image.transpose(0, 1).reshape(
            band.shape[0], n * band.shape[1], band.shape[2])
        counts = flat[:, -2:].contiguous().view(torch.int32)
        ctx.mark_non_differentiable(counts)
        return image, counts

    @staticmethod
    def backward(ctx, g_image, g_counts):
        r0, h = ctx.rows
        return g_image[:, r0:r0 + h], None, None, None


class _GatherRecords(torch.autograd.Function):
    """Every rank's (chunk, 10) records and (chunk, 6) int32 records, in
    rank order, in one all-gather; the backward returns this rank's chunk
    of the (N_pad, 10) gradient, which is the same on every rank."""

    @staticmethod
    def forward(ctx, x, ints, group):
        ctx.chunk = dist.get_rank(group) * x.shape[0], x.shape[0]
        rows = all_gather_cat(torch.cat([x, ints.view(torch.float32)], 1),
                              group)
        ints = rows[:, N_FIELD:].contiguous().view(torch.int32)
        ctx.mark_non_differentiable(ints)
        return rows[:, :N_FIELD].contiguous(), ints

    @staticmethod
    def backward(ctx, g, g_ints):
        r0, c = ctx.chunk
        return g[r0:r0 + c], None, None


class _ScatterInputs(torch.autograd.Function):
    """(N_pad, F) parameters -> this rank's (chunk, F) rows, and the pose
    through; the backward all-reduces every rank's chunk gradient at its
    rows, and the pose's, in one collective."""

    @staticmethod
    def forward(ctx, full, w2c, group, chunk):
        ctx.group = group
        ctx.shape = full.shape
        ctx.r0 = dist.get_rank(group) * chunk
        return full[ctx.r0:ctx.r0 + chunk].clone(), w2c.view_as(w2c)

    @staticmethod
    def backward(ctx, g_chunk, g_w2c):
        n_pad, f = ctx.shape
        want_full = ctx.needs_input_grad[0]
        buf = torch.zeros((n_pad * f if want_full else 0) + 16,
                          dtype=torch.float32, device=g_w2c.device
                          if g_w2c is not None else g_chunk.device)
        if want_full and g_chunk is not None:
            buf[ctx.r0 * f:ctx.r0 * f + g_chunk.numel()] = g_chunk.reshape(-1)
        if g_w2c is not None:
            buf[-16:] = g_w2c.reshape(-1)
        buf = all_reduce_sum(buf, ctx.group)
        g_full = buf[:-16].view(n_pad, f) if want_full else None
        g_pose = buf[-16:].view(4, 4) if ctx.needs_input_grad[1] else None
        return g_full, g_pose, None, None


def _project_sharded(mesh: Mesh, means3d, quats, log_scales, logit_opacity,
                     sh_coeffs, w2c, pcam, active, probe2d, sh_degree):
    """The per-Gaussian stage on this rank's chunk of N, gathered:
    (N_pad, 10) records and radius, rect, touched over N_pad."""
    n = means3d.shape[0]
    t = mesh.shape[TILE_AXIS]
    chunk = -(-n // t)
    npad = chunk * t - n
    dev = means3d.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if probe2d is None:
        probe2d = torch.zeros(n, 2, device=dev)
    k = sh_coeffs.shape[1]
    full = torch.cat([means3d, quats, log_scales, logit_opacity[:, None],
                      sh_coeffs.reshape(n, 3 * k), probe2d], dim=1)
    full = torch.cat([full, full.new_zeros(npad, full.shape[1])])
    active = torch.cat([active, active.new_zeros(npad)])
    r0 = mesh.tile_index * chunk
    if mesh.tiles_group is None:
        mine = full
    else:
        mine, w2c = _ScatterInputs.apply(full, w2c, mesh.tiles_group, chunk)
    m3, qt, ls, lo, shc, pr = torch.split(mine, [3, 4, 3, 1, 3 * k, 2], 1)
    proj, rgbz, opacity = _raster_inputs(
        m3, qt, ls, lo[:, 0], shc.reshape(-1, k, 3), w2c, pcam,
        active[r0:r0 + chunk], pr, sh_degree)
    x = torch.cat([proj.mean2d, proj.conic, opacity[:, None], rgbz], 1)
    ints = torch.cat([proj.radius[:, None], proj.tile_rect,
                      proj.tiles_touched[:, None]], 1).to(torch.int32)
    if mesh.tiles_group is not None:
        x, ints = _GatherRecords.apply(x, ints, mesh.tiles_group)
    return x, ints[:, 0], ints[:, 1:5], ints[:, 5]


def render_sharded_full(mesh: Mesh, means3d, quats, log_scales,
                        logit_opacity, sh_coeffs, w2c, cam: Camera, *,
                        active=None, probe2d=None, sh_degree: int = 0,
                        max_instances: int = 0, bg=None,
                        gs_grad: bool = True, cam_grad: bool = True,
                        shard_projection: bool | str = "auto",
                        grad_sum: str = "direct"):
    """Band-sharded render with the contract of ``ops/render.render``.

    Every rank of ``mesh``'s tiles group calls this with the same
    arguments and gets the same result: render (3, H, W), render_dep,
    render_sil, presence_mask, uncertainty, final_T, render_w2c, radii
    (unclipped), visibility, overflow and num_instances (summed over the
    bands), and band_overflow / band_num_instances (n,), each band's.
    ``max_instances`` (0 -> DEFAULT_MAX_INSTANCES) is divided over the
    bands (``band_instance_cap``). ``shard_projection`` "auto" shards the
    per-Gaussian stage when N >= SHARD_PROJECTION_MIN_N on more than one
    band. Differentiable in the Gaussians (unless ``gs_grad`` is False),
    the pose (unless ``cam_grad`` is False) and ``probe2d``; rows past
    cam.height (the bands' padding) are cropped. ``grad_sum``: the
    backward's reduction, "direct" (the bands chain one sum) or "prefix"
    (each band's prefix reduction, the bands' sums all-reduced; module
    doc).
    """
    n = means3d.shape[0]
    n_shards = mesh.shape[TILE_AXIS]
    group = mesh.tiles_group
    if shard_projection == "auto":
        shard_projection = n_shards > 1 and n >= SHARD_PROJECTION_MIN_N
    pcam = pad_height_for(cam, n_shards)
    band_h = pcam.height // n_shards
    grid_ty_band = band_h // TILE
    cap = band_instance_cap(max_instances or DEFAULT_MAX_INSTANCES, n_shards)
    if bg is None:
        bg = torch.ones(3, dtype=means3d.dtype, device=means3d.device)
    bg6 = torch.cat([bg, torch.ones(3, dtype=bg.dtype, device=bg.device)])

    w2c_used = w2c if cam_grad else w2c.detach()

    def gs(x):
        return x if gs_grad else x.detach()

    params = (gs(means3d), gs(quats), gs(log_scales), gs(logit_opacity),
              gs(sh_coeffs))
    if shard_projection:
        # the pose as returned keeps its local gradient (a loss on
        # render_w2c is the same on every rank and must not be summed)
        x, radius, rect, touched = _project_sharded(
            mesh, *params, w2c_used, pcam, active, probe2d, sh_degree)
        radii = radius[:n]
    else:
        proj, rgbz, opacity = _raster_inputs(*params, w2c_used, pcam, active,
                                             probe2d, sh_degree)
        x = torch.cat([proj.mean2d, proj.conic, opacity[:, None], rgbz], 1)
        radius, rect, touched = (proj.radius, proj.tile_rect,
                                 proj.tiles_touched)
        radii = radius

    # this rank's band
    b = mesh.tile_index
    mean2d, rect, touched, radius = _clip_to_band(
        b, band_h, grid_ty_band, x[:, 0:2], rect, touched, radius)
    rgbz = x[:, 6:10]
    bproj = ProjectedGaussians(mean2d=mean2d, conic=x[:, 2:5],
                               depth=rgbz[:, 3], radius=radius,
                               tile_rect=rect, tiles_touched=touched)
    out = rasterize(bproj, rgbz, x[:, 5],
                    RasterConfig(height=band_h, width=pcam.width,
                                 max_instances=cap, grad_sum=grad_sum),
                    band_sum=None if group is None
                    else _band_sum(group, grad_sum))
    band = torch.cat([out["image"] + out["final_T"][None]
                      * bg6[:, None, None], out["final_T"][None]])
    if group is None:
        image7 = band
        counts = torch.stack([out["overflow"], out["num_instances"]]
                             ).to(torch.int32)[None]
    else:
        image7, counts = _GatherBands.apply(band, out["overflow"],
                                            out["num_instances"], group)

    h = cam.height
    depth = image7[3, :h]
    sil = image7[4, :h]
    return {
        "render": image7[0:3, :h],
        "render_dep": depth,
        "render_sil": sil,
        "presence_mask": sil > 0.3,
        "uncertainty": (image7[5, :h] - depth * depth).detach(),
        "final_T": image7[6, :h],
        "render_w2c": w2c_used,
        "radii": radii,
        "visibility": radii > 0,
        "overflow": counts[:, 0].sum().to(torch.int32),
        "num_instances": counts[:, 1].sum().to(torch.int32),
        "band_overflow": counts[:, 0],
        "band_num_instances": counts[:, 1],
    }


def render_sharded(mesh: Mesh, means3d, quats, log_scales, logit_opacity,
                   sh_coeffs, w2c, cam: Camera, *, active=None,
                   sh_degree: int = 0, max_instances: int = 4096, bg=None,
                   grad_sum: str = "direct"):
    """Full-image render with tile rows sharded over the mesh: render
    (3, Hpad, W), render_dep, render_sil, final_T over the padded height
    (rows past cam.height are background) and pad_height. Differentiable
    in the Gaussians and the pose; ``grad_sum`` as
    ``render_sharded_full``'s."""
    pcam = pad_height_for(cam, mesh.shape[TILE_AXIS])
    out = render_sharded_full(mesh, means3d, quats, log_scales,
                              logit_opacity, sh_coeffs, w2c, pcam,
                              active=active, sh_degree=sh_degree,
                              max_instances=max_instances, bg=bg,
                              shard_projection=False, grad_sum=grad_sum)
    return {"render": out["render"], "render_dep": out["render_dep"],
            "render_sil": out["render_sil"], "final_T": out["final_T"],
            "pad_height": pcam.height}


def sharded_train_step(mesh: Mesh, params: dict, w2c, gt_image,
                       cam: Camera, *, sh_degree: int = 0,
                       max_instances: int = 4096, lr: float = 1e-3,
                       grad_sum: str = "direct"):
    """One SGD step on the sharded renderer's padded-image mean-squared
    error. params: means, quats, log_scales, logit_opacity, sh; gt_image
    (3, Hpad, W). Returns (new_params, loss)."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = render_sharded(mesh, p["means"], p["quats"], p["log_scales"],
                         p["logit_opacity"], p["sh"], w2c, cam,
                         sh_degree=sh_degree, max_instances=max_instances,
                         grad_sum=grad_sum)
    loss = torch.mean((out["render"] - gt_image) ** 2)
    grads = torch.autograd.grad(loss, list(p.values()))
    return ({k: (v - lr * g).detach() for (k, v), g in zip(p.items(), grads)},
            loss.detach())
