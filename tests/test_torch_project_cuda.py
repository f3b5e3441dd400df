"""ops/project_cuda.py on the CPU: ``Project``'s plain forward against the
projection op by op, its hand-derived backward against autograd of that
forward and against ``jax.grad`` of the JAX package's projection + SH, at
SH degrees 0-4, on scenes with every edge the backward must keep: unused
zero-mean slots, Gaussians culled by z <= 0.2 and by ``active``, the EWA
clamp engaged, an SH value at exactly 0 (the tie of ``torch.maximum``),
the pose's gradient with the Gaussians frozen (tracking), and the densify
probe. The scene is ``chip_smoke.py``'s, whose ``project`` phase holds the
kernels themselves to the plain version on this scene and at the
benchmark's size on the card (``tests_card/test_project_card.py``).

Tolerances: the plain forward is the same ops, so bitwise; the hand-derived
backward sums the same terms as autograd in another order, within 1e-6 of
each tensor's largest magnitude in float32 at degrees 0-3 (rounding of a
few dozen terms) and 1e-12 in float64 at degrees 0-4;
against jax.grad the 1e-5 of ``tests/test_torch_projection.py``. Conic
gradients of culled Gaussians are masked, as there: their covariance may be
degenerate.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.core.sh import sh_to_rgb_clamped as jsh_rgb
from freesurgs_tpu.core.transforms import build_w2c as jbuild, \
    transform_points as jtp
from freesurgs_tpu.ops.projection import project_gaussians as jproj
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.core.sh import eval_sh
from freesurgs_tpu_torch.core.transforms import build_w2c as tbuild
from freesurgs_tpu_torch.ops.project_cuda import raster_inputs, \
    raster_inputs_plain

# the edge scene is chip_smoke.py's (beside tests/), which the card holds
# the kernels to as well
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import PROJECT_EDGE_CAM, PROJECT_EDGE_CASES, \
    PROJECT_EDGE_N, PROJECT_EDGE_POSE, PROJECT_EDGE_UNUSED, \
    project_edge_scene  # noqa: E402

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)

KW = PROJECT_EDGE_CAM
N, N_UNUSED = PROJECT_EDGE_N, PROJECT_EDGE_UNUSED
Q0, T0 = (np.asarray(v, np.float32) for v in PROJECT_EDGE_POSE)
CASES = PROJECT_EDGE_CASES
scene = project_edge_scene


def torch_inputs(arrays, grad=True, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrays]


def loss_of(out, cot, vis):
    proj, rgbz, opacity = out
    c = [torch.tensor(x, dtype=rgbz.dtype) for x in cot]
    return ((proj.mean2d * c[0]).sum()
            + (proj.conic * c[1] * vis[:, None]).sum()
            + (rgbz * c[2]).sum() + (opacity * c[3]).sum())


def norm_close(want, got, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("probe,use_active", [(False, False), (True, True)])
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_plain_forward_is_the_ops(sh_degree, probe, use_active):
    """``raster_inputs`` on the CPU: bit for bit the projection op by op,
    every output, and the culls and the tie are where the scene puts them."""
    arrays, active, pr, _ = scene(sh_degree)
    ins = torch_inputs(arrays, grad=False)
    cam = TCam(**KW)
    w2c = tbuild(torch.tensor(Q0), torch.tensor(T0))
    act = torch.tensor(active) if use_active else None
    prb = torch.tensor(pr) + 0.25 if probe else None
    got = raster_inputs(*ins, w2c, cam, act, prb, sh_degree)
    want = raster_inputs_plain(*ins, w2c, cam, act, prb, sh_degree)
    for a, b in zip(list(got[0]) + list(got[1:]),
                    list(want[0]) + list(want[1:])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    radius = got[0].radius
    assert 0 < int((radius > 0).sum()) < N - N_UNUSED
    assert int((radius[20:40] > 0).sum()) < 20          # near-culled
    assert torch.all(radius[N - N_UNUSED:] == 0)
    means = ins[0]
    dirs = means[:1] / torch.linalg.norm(means[:1])
    v = eval_sh(sh_degree, ins[4][:1], dirs)[0, 0] + 0.5
    assert float(v) == 0.0 and float(got[1][0, 0]) == 0.0


# (dtype, SH degree, tolerance): float32 at the degrees training uses; in
# float64 the two agree to rounding at every degree, so a wrong term shows
# (degree 4's view-direction gradient cancels down to float32 rounding of
# ~1e-6 in autograd and in the hand-derived order alike)
DTYPES = [(torch.float32, d, 1e-6) for d in range(4)] \
    + [(torch.float64, d, 1e-12) for d in range(5)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype,sh_degree,tol", DTYPES)
def test_backward_matches_autograd(dtype, sh_degree, tol, case):
    """The hand-derived backward against autograd through the same plain
    forward: every input's gradient, the pose's through build_w2c."""
    gs, pose, use_probe, use_active = CASES[case]
    arrays, active, pr, cot = scene(sh_degree, seed=sh_degree + 1)
    cam = TCam(**KW)
    act = torch.tensor(active) if use_active else None
    grads = []
    for fn in (raster_inputs, raster_inputs_plain):
        ins = torch_inputs(arrays, grad=gs, dtype=dtype)
        q = torch.tensor(Q0, dtype=dtype, requires_grad=pose)
        t = torch.tensor(T0, dtype=dtype, requires_grad=pose)
        prb = (torch.tensor(pr, dtype=dtype, requires_grad=True)
               if use_probe else None)
        out = fn(*ins, tbuild(q, t), cam, act, prb, sh_degree)
        vis = (out[0].radius > 0).to(dtype)
        leaves = ((ins if gs else []) + ([q, t] if pose else [])
                  + ([prb] if use_probe else []))
        grads.append(torch.autograd.grad(loss_of(out, cot, vis), leaves))
    assert len(grads[0]) == len(grads[1]) > 0
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        norm_close(want.numpy(), got, tol)
    if gs:
        # unused zero-mean slots: exactly zero, finite gradients
        for g in grads[0][:5]:
            assert torch.all(g[N - N_UNUSED:] == 0)


def jax_raster_inputs(means, quats, ls, lo, sh, q, t, probe, active, cam,
                      sh_degree):
    """The JAX package's projection + SH, as its ``render`` computes them."""
    mean_cam = jtp(jbuild(q, t), means)
    proj = jproj(mean_cam, jnp.exp(ls), quats, cam, active=active)
    n2 = jnp.sum(means * means, axis=-1, keepdims=True)
    dirs = means * jax.lax.rsqrt(jnp.maximum(n2, 1e-16))
    rgb = jsh_rgb(sh_degree, sh, dirs)
    rgbz = jnp.concatenate([rgb, proj.depth[:, None]], axis=1)
    return proj.mean2d + probe, proj.conic, rgbz, jax.nn.sigmoid(lo), \
        proj.radius


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_backward_matches_jax_grad(sh_degree):
    """Every gradient (Gaussians, pose, probe) against jax.grad of the JAX
    package's projection + SH on the same inputs and cotangents. No rgb tie:
    XLA fuses C0 x + 0.5 into one rounding, so the tie is not one there."""
    arrays, active, pr, cot = scene(sh_degree, seed=10 + sh_degree,
                                    tie=False)
    jcam = JCam(**KW)

    def jloss(means, quats, ls, lo, sh, q, t, probe, vis):
        m2, con, rgbz, op, _ = jax_raster_inputs(
            means, quats, ls, lo, sh, q, t, probe, jnp.asarray(active), jcam,
            sh_degree)
        return (jnp.sum(m2 * cot[0]) + jnp.sum(con * cot[1] * vis[:, None])
                + jnp.sum(rgbz * cot[2]) + jnp.sum(op * cot[3]))

    args = [jnp.asarray(a) for a in (*arrays, Q0, T0, pr)]
    radius = jax.jit(jax_raster_inputs, static_argnums=(9, 10))(
        *args, jnp.asarray(active), jcam, sh_degree)[4]
    vis = (np.asarray(radius) > 0).astype(np.float32)
    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(
        *args, jnp.asarray(vis))

    ins = torch_inputs(arrays)
    q = torch.tensor(Q0, requires_grad=True)
    t = torch.tensor(T0, requires_grad=True)
    prb = torch.tensor(pr, requires_grad=True)
    out = raster_inputs(*ins, tbuild(q, t), TCam(**KW), torch.tensor(active),
                        prb, sh_degree)
    np.testing.assert_array_equal(out[0].radius.numpy(), np.asarray(radius))
    gt = torch.autograd.grad(loss_of(out, cot, torch.tensor(vis)),
                             ins + [q, t, prb])
    for a, b in zip(gj, gt):
        norm_close(a, b, 1e-5)
