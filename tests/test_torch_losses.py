"""The port's SSIM, losses and Adam against freesurgs_tpu's on seeded inputs.

Tolerances: losses are means of O(1) f32 terms, so values agree to 1e-6
(SSIM's blur sums 121 products in another order: 2e-6); gradients are
compared at rtol 1e-4 / atol 1e-7, the f32 noise of per-pixel chains.
Adam runs the same f32 formula: updates and moments to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesurgs_tpu.core.camera import Camera as JCam
from freesurgs_tpu.core.transforms import build_w2c as jbuild
from freesurgs_tpu.ops.ssim import ssim as jssim
from freesurgs_tpu.train import losses as jl
from freesurgs_tpu.train import optim as jo
from freesurgs_tpu_torch.core.camera import Camera as TCam
from freesurgs_tpu_torch.core.transforms import build_w2c as tbuild
from freesurgs_tpu_torch.ops.ssim import ssim as tssim
from freesurgs_tpu_torch.train import losses as tl
from freesurgs_tpu_torch.train import optim as to

# One intra-op thread: these tensors are small, and the suite runs six
# workers on the machine's cores.
torch.set_num_threads(1)


def T(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def images(seed, c=3, h=40, w=52):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (c, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_ssim_value_and_grad():
    a, b = images(0)
    jv, jg = jax.value_and_grad(lambda x: jssim(x, jnp.asarray(b)))(
        jnp.asarray(a))
    ta = T(a, True)
    tv = tssim(ta, T(b))
    tv.backward()
    np.testing.assert_allclose(float(jv), tv.item(), atol=2e-6)
    np.testing.assert_allclose(np.asarray(jg), ta.grad.numpy(), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_rgb_loss(masked):
    a, b = images(1)
    mask = (np.random.default_rng(2).uniform(size=a.shape[1:]) > 0.3
            if masked else None)
    jv, jg = jax.value_and_grad(lambda x: jl.rgb_loss(
        x, jnp.asarray(b), None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(a))
    ta = T(a, True)
    tv = tl.rgb_loss(ta, T(b), None if mask is None else T(mask))
    tv.backward()
    np.testing.assert_allclose(float(jv), tv.item(), atol=2e-6)
    np.testing.assert_allclose(np.asarray(jg), ta.grad.numpy(), rtol=1e-4,
                               atol=1e-7)


def test_pearson_and_local_pearson():
    rng = np.random.default_rng(3)
    src = rng.uniform(0.5, 1.5, (300, 280)).astype(np.float32)
    tgt = (src * 2 + rng.normal(0, 0.2, src.shape)).astype(np.float32)
    np.testing.assert_allclose(
        float(jl.pearson_depth_loss(jnp.asarray(src), jnp.asarray(tgt))),
        float(tl.pearson_depth_loss(T(src), T(tgt))), atol=1e-6)
    # constant map: a finite gradient, the same on both sides
    g = jax.grad(lambda x: jl.pearson_depth_loss(x, jnp.asarray(tgt)))(
        jnp.ones_like(jnp.asarray(src)))
    tc = torch.ones(src.shape, requires_grad=True)
    tl.pearson_depth_loss(tc, T(tgt)).backward()
    assert np.all(np.isfinite(tc.grad.numpy()))
    np.testing.assert_allclose(np.asarray(g), tc.grad.numpy(), rtol=1e-4)

    key = jax.random.PRNGKey(7)
    jv = jl.local_pearson_loss(jnp.asarray(src), jnp.asarray(tgt), key)
    # the same box corners JAX drew (losses.py local_pearson_loss)
    h, w = src.shape
    box = min(128, h, w)
    n_boxes = max(int(0.5 * (h // box) * (w // box)), 1)
    kx, ky = jax.random.split(key)
    x0 = jax.random.randint(kx, (n_boxes,), 0, max(h - box, 1))
    y0 = jax.random.randint(ky, (n_boxes,), 0, max(w - box, 1))
    tv = tl.local_pearson_loss(T(src), T(tgt), T(x0).long(), T(y0).long())
    np.testing.assert_allclose(float(jv), float(tv), atol=1e-6)
    gx, gy = tl.local_pearson_boxes(h, w, torch.Generator().manual_seed(0))
    assert gx.shape == (n_boxes,) and int(gx.max()) < h - box + 1


def test_flow_projection_loss():
    rng = np.random.default_rng(4)
    kw = dict(height=64, width=80, fx=70.0, fy=70.0, cx=40.0, cy=32.0)
    depth = rng.uniform(1.0, 2.0, (64, 80)).astype(np.float32)
    depth[:5] = 0.0                      # invalid region
    flow = rng.normal(0, 1.0, (2, 64, 80)).astype(np.float32)
    rigid = (rng.uniform(size=(64, 80)) > 0.2).astype(np.float32)
    prev = np.asarray(jbuild(jnp.asarray([1.0, 0.0, 0.0, 0.0]),
                             jnp.asarray([0.0, 0.0, 0.0])))
    q = np.asarray([0.999, 0.01, -0.02, 0.005], np.float32)
    t = np.asarray([0.02, -0.01, 0.03], np.float32)

    def jf(q, t):
        return jl.flow_projection_loss(jnp.asarray(depth), jnp.asarray(prev),
                                       jbuild(q, t), jnp.asarray(flow),
                                       JCam(**kw), jnp.asarray(rigid))

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(q),
                                                    jnp.asarray(t))
    tq, tt = T(q, True), T(t, True)
    tv = tl.flow_projection_loss(T(depth), T(prev), tbuild(tq, tt), T(flow),
                                 TCam(**kw), T(rigid))
    tv.backward()
    np.testing.assert_allclose(float(jv), tv.item(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(jg[0]), tq.grad.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jg[1]), tt.grad.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_flow_projection_loss_bf16_cache_wide():
    """The tracker hands the loss its bf16 depth cache. JAX back-projects it
    in bf16 (a pixel grid coarser than one pixel past x = 256), and so must
    the port: at 640 px wide an f32 back-projection moves the loss by
    about 2%. Same tolerances as above (bf16 rounding agrees op for op);
    the gradients' atol is 1e-4 of entries up to ~500."""
    rng = np.random.default_rng(8)
    H, W = 48, 640
    kw = dict(height=H, width=W, fx=0.8 * W, fy=0.8 * W, cx=W / 2,
              cy=H / 2)
    depth = rng.uniform(1.0, 2.0, (H, W)).astype(np.float32)
    flow = rng.normal(0, 1.0, (2, H, W)).astype(np.float32)
    prev = np.asarray(jbuild(jnp.asarray([1.0, 0.0, 0.0, 0.0]),
                             jnp.asarray([0.0, 0.0, 0.0])))
    q = np.asarray([0.9999, 0.002, -0.003, 0.001], np.float32)
    t = np.asarray([0.01, -0.005, 0.01], np.float32)

    def jf(q, t):
        return jl.flow_projection_loss(
            jnp.asarray(depth, jnp.bfloat16), jnp.asarray(prev),
            jbuild(q, t), jnp.asarray(flow), JCam(**kw))

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(q),
                                                    jnp.asarray(t))
    tq, tt = T(q, True), T(t, True)
    tv = tl.flow_projection_loss(T(depth).to(torch.bfloat16), T(prev),
                                 tbuild(tq, tt), T(flow), TCam(**kw))
    tv.backward()
    np.testing.assert_allclose(float(jv), tv.item(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(jg[0]), tq.grad.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jg[1]), tt.grad.numpy(),
                               rtol=1e-4, atol=1e-4)
    f32 = tl.flow_projection_loss(T(depth), T(prev), tbuild(T(q), T(t)),
                                  T(flow), TCam(**kw))
    assert abs(float(f32) / float(jv) - 1.0) > 0.01   # the case is live


def test_scale_shift_invariant_loss():
    rng = np.random.default_rng(5)
    pred = rng.uniform(0.2, 2.0, (2, 48, 40)).astype(np.float32)
    tgt = (3 * pred + 0.5 + rng.normal(0, 0.05, pred.shape)).astype(
        np.float32)
    mask = (rng.uniform(size=pred.shape) > 0.2).astype(np.float32)
    js, jt = jl.compute_scale_and_shift(*map(jnp.asarray, (pred, tgt, mask)))
    ts, tt = tl.compute_scale_and_shift(T(pred), T(tgt), T(mask))
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        float(jl.scale_shift_invariant_loss(*map(jnp.asarray,
                                                 (pred, tgt, mask)))),
        float(tl.scale_shift_invariant_loss(T(pred), T(tgt), T(mask))),
        rtol=1e-4)


def test_adam_schedules_and_surgery():
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(10, 3)).astype(np.float32),
              "b": rng.normal(size=(10,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: T(v) for k, v in params.items()}
    js, ts = jo.adam_init(jp), to.adam_init(tp)
    for step in range(1, 6):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -step
             for k, v in params.items()}
        jlr = {"a": jo.expon_lr(step, 8e-4, 8e-6, 30000),
               "b": jo.tracking_lr(step, 10)}
        tlr = {"a": to.expon_lr(step, 8e-4, 8e-6, 30000),
               "b": to.tracking_lr(step, 10)}
        np.testing.assert_allclose(float(jlr["a"]), float(tlr["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(jlr["b"]), float(tlr["b"]),
                                   rtol=1e-6)
        ju, js = jo.adam_update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jlr)
        tu, ts = to.adam_update({k: T(v) for k, v in g.items()}, ts, tlr)
        jp, tp = jo.apply_updates(jp, ju), to.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(np.asarray(ju[k]), tu[k].numpy(),
                                       rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(np.asarray(jp[k]), tp[k].numpy(),
                                       rtol=1e-6, atol=1e-7)
    assert int(js.count) == ts.count == 5
    for k in params:
        np.testing.assert_allclose(np.asarray(js.mu[k]), ts.mu[k].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(js.nu[k]), ts.nu[k].numpy(),
                                   rtol=1e-5)
    mask = np.arange(10) % 3 == 0
    js2 = jo.surgery_mask_moments(js, jnp.asarray(mask))
    ts2 = to.surgery_mask_moments(ts, T(mask))
    for k in params:
        np.testing.assert_allclose(np.asarray(js2.mu[k]), ts2.mu[k].numpy(),
                                   rtol=1e-5)
        assert np.all(ts2.nu[k].numpy()[mask] == 0)
