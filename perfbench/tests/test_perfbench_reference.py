"""The plain reference against the program's plain (CPU) path at a tiny
size, so that a wrong reference is caught before a run on the card: a
render fresh and on a carried layout, and mapping iterations (loss,
gradients, Adam) from one state."""


import numpy as np
import pytest
import torch

from freesurgs_tpu_torch.core.camera import Camera
from freesurgs_tpu_torch.core.transforms import build_w2c
from freesurgs_tpu_torch.models.gaussians import from_pointcloud
from freesurgs_tpu_torch.ops.render import render as prog_render
from freesurgs_tpu_torch.train.optim import adam_init
from freesurgs_tpu_torch.train.steps import (MappingState, TrainConfig,
                                             mapping_chunk)
from perfbench.reference import mapping as ref
from perfbench.reference import render as R
from perfbench.tests.test_perfbench_work import _scene

H, W = 40, 56


def _cams():
    cam = R.Cam(H, W, W * 1.1, W * 1.1, W / 2, H / 2)
    return cam, Camera(height=H, width=W, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                       cy=cam.cy)


def _w2c(seed):
    g = torch.Generator().manual_seed(100 + seed)
    q = torch.cat([torch.ones(1), 0.03 * torch.randn(3, generator=g)])
    t = 0.05 * torch.randn(3, generator=g)
    return build_w2c(q, t)


def _prog(params, w2c, cam, **kw):
    sh = torch.cat([params["sh_dc"], params["sh_rest"]], 1)
    return prog_render(params["means"], params["quats"],
                       params["log_scales"], params["logit_opacity"], sh,
                       w2c, cam, sh_degree=3, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_program(seed):
    params, active, cam = _scene(seed, h=H, w=W)
    rc, pc = _cams()
    w2c = _w2c(seed)
    with torch.no_grad():
        out = R.render(params, active, w2c, rc, 3)[2]
        prog = _prog(params, w2c, pc)
    img = out["image"]
    np.testing.assert_allclose(img[0:3], prog["render"], atol=2e-5)
    np.testing.assert_allclose(img[3], prog["render_dep"], atol=2e-5)
    np.testing.assert_allclose(out["final_T"], prog["final_T"], atol=2e-5)


def test_carried_render_matches_program():
    params, active, cam = _scene(3, h=H, w=W)
    rc, pc = _cams()
    w2c = _w2c(3)
    g = torch.Generator().manual_seed(9)
    moved = dict(params)
    moved["means"] = params["means"] + 0.02 * torch.randn(
        params["means"].shape, generator=g)
    moved["log_scales"] = params["log_scales"] + 0.2
    with torch.no_grad():
        _, _, _, carry = R.render(params, active, w2c, rc, 3)
        out = R.render(moved, active, w2c, rc, 3, carry=carry)[2]
        fresh = R.render(moved, active, w2c, rc, 3)[2]
        first = _prog(params, w2c, pc, rebin=True)
        prog = _prog(moved, w2c, pc, bins=first["bins"], rebin=False)
    np.testing.assert_allclose(out["image"][0:3], prog["render"], atol=2e-5)
    np.testing.assert_allclose(out["image"][3], prog["render_dep"],
                               atol=2e-5)
    # the carry is not a fresh render: the moved Gaussians lose coverage
    assert (fresh["image"][0:3] - prog["render"]).abs().max() > 1e-3


@pytest.mark.parametrize("rebin_every", [1, 4])
def test_mapping_steps_match_program(rebin_every):
    params, active, cam = _scene(4, h=H, w=W)
    rc, pc = _cams()
    n = params["means"].shape[0]
    field = from_pointcloud(params["means"], torch.rand(n, 3), 1.0,
                            capacity=n)
    field = field.replace(**{k: v.clone() for k, v in params.items()})
    opt = adam_init(field.param_dict())
    gen = torch.Generator().manual_seed(5)
    state = MappingState(field=field, opt=opt, iteration=21000,
                         generator=gen,
                         pred_depths=torch.zeros(3, H, W,
                                                 dtype=torch.bfloat16),
                         pred_colors=torch.zeros(3, 3, H, W,
                                                 dtype=torch.bfloat16))
    state.opt.count = 21000
    g = torch.Generator().manual_seed(6)
    colors = torch.rand(3, 3, H, W, generator=g)
    prior = 1.0 + torch.rand(3, H, W, generator=g)
    w2c = torch.stack([_w2c(i) for i in range(3)])
    cfg = TrainConfig(rebin_every=rebin_every)
    frames = [1, 1, 2]
    s0 = {"params": {k: v.clone() for k, v in field.param_dict().items()},
          "mu": {k: v.clone() for k, v in opt.mu.items()},
          "nu": {k: v.clone() for k, v in opt.nu.items()},
          "active": active, "count": 21000, "iteration": 21000,
          "sh_degree": 3}
    boxes_gen = torch.Generator()
    boxes_gen.set_state(gen.get_state())
    new, aux = mapping_chunk(state, colors, prior, w2c, frames, [], pc, cfg,
                             two_views=False, sh_degree=3)
    rebins = [True, rebin_every == 1, True]
    schedule = [(f, rb, ref.box_corners(H, W, boxes_gen, "cpu"))
                for f, rb in zip(frames, rebins)]
    seq = type("S", (), {"w2c": w2c, "colors": colors, "prior": prior})
    out = ref.follow(s0, schedule, seq, rc, cfg._asdict())
    assert out["losses"][-1] == pytest.approx(float(aux["loss"]), rel=1e-5)
    for k in ref.LEAVES:
        np.testing.assert_allclose(out["params"][k],
                                   getattr(new.field, k), atol=1e-6,
                                   rtol=1e-4)


@pytest.mark.parametrize("prior", ["metric", "normalized"])
def test_initial_map_matches_program(prior):
    """The reference's initial map against the one the program's Trainer
    builds from the same sequence and seed (the program's 3-NN distances
    come from |x|^2 + |y|^2 - 2 x.y in float32, hence the scales' room)."""
    import types

    from freesurgs_tpu_torch.train.loop import Trainer
    from perfbench import scene
    from perfbench.tests import tiny

    spec = tiny.tiny_spec("scared_cfg34")
    spec["data"]["depth_prior"] = prior
    seq = scene.make_sequence(2 ** 31 + 5, spec, "cpu")
    h, w = seq.height, seq.width
    pseq = types.SimpleNamespace(
        cam=Camera.from_K(seq.K, height=h, width=w), colors=seq.colors,
        monodeps=seq.monodeps, flows_fw=seq.flows_fw, i_train=seq.i_train,
        i_test=seq.i_test, gt_poses={"k0": seq.gt_w2c},
        boundaries=[0, seq.colors.shape[0]])
    trainer = Trainer(pseq, TrainConfig(), sh_degree_max=3,
                      init_mask_frac=0.1, seed=2 ** 31 + 5,
                      log_fn=lambda m: None, validation_every=0,
                      device="cpu")
    init = ref.initial_map(seq, 0.1, 2 ** 31 + 5, 3)
    field = trainer.field
    n = init["means"].shape[0]
    assert int(field.num_active) == n and bool(field.active[:n].all())
    for k in ref.LEAVES:
        np.testing.assert_allclose(init[k], getattr(field, k)[:n],
                                   rtol=1e-5, atol=1e-4 if k == "log_scales"
                                   else 1e-6, err_msg=k)
