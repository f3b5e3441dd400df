"""The port's ``render`` (binned compositing; the plain kernel versions on the
CPU) against the JAX ``render(impl="oracle")`` at SH degree 0 and 3: the
six outputs, radii and overflow; gradients for every Gaussian parameter,
the pose (cam_grad) and the densify probe; a capacity with inactive slots
whose gradients must be exactly 0 and finite.

Tolerances: rendered channels within 2e-5 absolute (the JAX package's
oracle-vs-Pallas gate), depth^2 - depth^2 (uncertainty) within 1e-4 since it
cancels two O(10) terms; gradients within 5e-5 after normalizing each by
its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.data.synthetic import make_scene as jmake_scene
from freesurgs_tpu.ops.render import render as jrender
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.data.synthetic import make_scene as tmake_scene
from freesurgs_tpu_torch.ops.render import render as trender

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

H, W = 40, 56
CAMKW = dict(height=H, width=W, fx=0.9 * W, fy=0.9 * W, cx=W / 2, cy=H / 2)
N_ACTIVE, CAP = 250, 320


def field(sh_degree, seed):
    """A slot pool: N_ACTIVE live Gaussians, the rest zero-filled inactive
    slots (zero means, identity quats) as GaussianField pads them."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    means = np.zeros((CAP, 3), np.float32)
    means[:N_ACTIVE] = np.stack([rng.uniform(-0.8, 0.8, N_ACTIVE),
                                 rng.uniform(-0.6, 0.6, N_ACTIVE),
                                 rng.uniform(0.5, 3.0, N_ACTIVE)], -1)
    quats = np.zeros((CAP, 4), np.float32)
    quats[:, 0] = 1.0
    quats[:N_ACTIVE] = rng.normal(size=(N_ACTIVE, 4))
    ls = np.zeros((CAP, 3), np.float32)
    ls[:N_ACTIVE] = np.log(rng.uniform(0.02, 0.1, (N_ACTIVE, 3)))
    lo = np.zeros(CAP, np.float32)
    lo[:N_ACTIVE] = rng.uniform(-2, 3, N_ACTIVE)
    sh = np.zeros((CAP, k, 3), np.float32)
    sh[:N_ACTIVE] = rng.normal(size=(N_ACTIVE, k, 3)) * 0.3
    active = np.arange(CAP) < N_ACTIVE
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.03, -0.02, 0.05]
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((3, H, W), (H, W), (H, W), (H, W))]
    return (means, quats, ls, lo, sh, w2c), active, w


def loss_terms(out, w):
    return (out["render"] * w[0], out["render_dep"] * w[1],
            out["render_sil"] * w[2], out["final_T"] * w[3])


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_render_outputs_and_gradients(sh_degree):
    params, active, w = field(sh_degree, 10 + sh_degree)
    probe = np.zeros((CAP, 2), np.float32)

    def jl(m, q, s, o, c, v, p):
        out = jrender(m, q, s, o, c, v, JCam(**CAMKW),
                      active=jnp.asarray(active), probe2d=p,
                      sh_degree=sh_degree, impl="oracle")
        return sum(jnp.sum(x) for x in loss_terms(out, w)), out

    (_, jo), jg = jax.value_and_grad(jl, argnums=tuple(range(7)),
                                     has_aux=True)(
        *map(jnp.asarray, params + (probe,)))
    ts = [torch.tensor(x, requires_grad=True) for x in params + (probe,)]
    to = trender(*ts[:6], TCam(**CAMKW), active=torch.tensor(active),
                 probe2d=ts[6], sh_degree=sh_degree)
    sum(x.sum() for x in loss_terms(to, [torch.tensor(x) for x in w])
        ).backward()

    for k in ("render", "render_dep", "render_sil", "final_T"):
        np.testing.assert_allclose(np.asarray(jo[k]), to[k].detach().numpy(),
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(np.asarray(jo["uncertainty"]),
                               to["uncertainty"].numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jo["radii"]),
                                  to["radii"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["presence_mask"]),
                                  to["presence_mask"].numpy())
    assert int(jo["overflow"]) == int(to["overflow"]) == 0

    names = ("means", "quats", "log_scales", "logit_opacity", "sh", "w2c",
             "probe2d")
    for name, a, b in zip(names, jg, ts):
        a, b = np.asarray(a), b.grad.numpy()
        assert np.all(np.isfinite(b)), name
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-5,
                                   err_msg=name)
        if name not in ("w2c",):
            # inactive slots: exactly zero, on both sides
            assert np.all(b[N_ACTIVE:] == 0.0), name
            assert np.all(a[N_ACTIVE:] == 0.0), name


def test_gs_and_cam_grad_switches():
    """Tracking mode (cam only) and mapping mode (Gaussians only)."""
    params, active, w = field(0, 20)
    ts = [torch.tensor(x, requires_grad=True) for x in params]
    out = trender(*ts[:6], TCam(**CAMKW), active=torch.tensor(active),
                  gs_grad=False, cam_grad=True)
    out["render"].sum().backward()
    assert all(t.grad is None for t in ts[:5])
    assert ts[5].grad is not None and torch.any(ts[5].grad != 0)
    ts = [torch.tensor(x, requires_grad=True) for x in params]
    out = trender(*ts[:6], TCam(**CAMKW), active=torch.tensor(active),
                  gs_grad=True, cam_grad=False)
    out["render"].sum().backward()
    assert ts[5].grad is None and torch.any(ts[0].grad != 0)


def test_make_scene():
    """The synthetic video: the same seeded draws, frames rendered by each
    package (JAX oracle, port binned compositing). Frames and depths to the
    render gate (2e-5; depth within 1e-4 as z reaches 2.5); the analytic
    flow divides by depth, so it holds to 1e-3 px."""
    kw = dict(num_frames=3, n_gaussians=200, height=32, width=48, seed=4)
    j = jmake_scene(impl="oracle", **kw)
    t = tmake_scene(device="cpu", **kw)
    for k, tol in (("gt_quats", 1e-7), ("gt_trans", 1e-7), ("gt_w2c", 1e-6),
                   ("means", 0), ("sh", 1e-7), ("colors", 2e-5),
                   ("depths", 1e-4), ("monodeps", 1e-4), ("flows_fw", 1e-3)):
        np.testing.assert_allclose(np.asarray(getattr(j, k)),
                                   getattr(t, k).numpy(), atol=tol,
                                   err_msg=k)


def test_render_records_are_what_render_composites():
    """``render_records`` bins the view exactly as ``render`` does: the
    forward compositing of its records is ``render``'s image, bit for
    bit."""
    from freesurgs_tpu_torch.ops.raster_cuda import composite_fwd
    from freesurgs_tpu_torch.ops.render import render_records
    params, active, _ = field(3, 30)
    ts = [torch.tensor(x) for x in params]
    cam = TCam(**CAMKW)
    out = trender(*ts, cam, active=torch.tensor(active), sh_degree=3)
    cfg, feat, rect, bins = render_records(*ts, cam,
                                           active=torch.tensor(active),
                                           sh_degree=3)
    assert int(bins.overflow) == 0 and feat.shape == (10, rect.shape[0])
    img, _ = composite_fwd(feat, rect, bins.tile_start, bins.tile_count,
                           cfg.grid_x, cfg.grid_y)
    T = img[6, :H, :W]
    torch.testing.assert_close(img[0:3, :H, :W] + T, out["render"],
                               rtol=0, atol=0)
    torch.testing.assert_close(T, out["final_T"], rtol=0, atol=0)
