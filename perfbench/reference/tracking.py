"""Plain PyTorch reference of Free-SurGS's per-frame tracking and of its
two-view mapping iteration.

Tracking a frame t (wrld/Free-SurGS ``train.py`` tracking, with the
system's Gauss-Newton init) as the system under test states it:

- the rigidity mask: the Sampson distance of each pixel of frame t-2 and
  its forward flow to frame t-1 under the fundamental matrix
  K^-T [t_rel]x R_rel K^-1 of the two poses (0 where the flow leaves the
  image), kept where it is at most its mean + 2 population standard
  deviations;
- the init: constant velocity from frames t-1 and t-2 (the quaternion
  normalize(q1 + (q1 - q2)), the translation t1 + (t1 - t2));
- Gauss-Newton flow-PnP: frame t-1's pixels back-projected through its
  rendered-depth cache (float32) into the world by its pose, their flow
  targets as observations; ``iters`` steps of Huber-reweighted normal
  equations over every valid pixel (depth > 0, in the mask, target more
  than 20 px inside the image, z > 1e-3), Levenberg damping of 1e-4 times
  the diagonal plus 1e-8, the twist applied on the left, and no step where
  the total weight is below 64;
- the tracking loss: 1.0 * (0.8 L1 + 0.2 (1 - SSIM)) of the render and the
  frame, both multiplied by the mask (rendered depth > 0 and rigid), means
  over all pixels, + 0.1 * the flow-projection loss: frame t-1's depth
  cache back-projected in the cache's own dtype (bfloat16 grid and
  products, as the system states it), through the inverse of its pose and
  the current pose, projected with z + 1e-5; the mean L1 against the flow
  over valid pixels (depth > 0, rigid, projection more than 20 px inside,
  z > 0) times two components;
- Adam on (quaternion, translation), betas 0.9 / 0.999, eps 1e-15, the
  learning rate 0.01 halved at 0, 1/3 and 2/3 of the tracking budget
  (``replay_tracking``).

The two-view mapping iteration sums the mapping loss of the keyframe view
and of the current view (``mapping.mapping_loss``, each with its own
boxes), each view reusing its own layout carry, then one Adam step as in
``mapping.follow``. Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

from . import mapping as M
from . import render as R

EDGE = 20


def w2c(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(4, 4) world-to-camera of an unnormalized (w, x, y, z) quaternion and
    a translation."""
    top = torch.cat([R.quat_rotmat(q), t[:, None]], 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                          device=top.device)
    return torch.cat([top, bottom], 0)


def invert(T: torch.Tensor) -> torch.Tensor:
    Ri = T[:3, :3].T
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = Ri
    out[:3, 3] = -(Ri @ T[:3, 3])
    return out


def const_velocity(q1, t1, q2, t2):
    """Frame t's init from frame t-1 (q1, t1) and t-2 (q2, t2)."""
    def unit(q):
        return q / torch.clamp_min(torch.linalg.norm(q), 1e-12)
    a, b = unit(q1), unit(q2)
    return unit(a + (a - b)), t1 + (t1 - t2)


def _grid(h: int, w: int, dtype, device):
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return xg.reshape(-1), yg.reshape(-1)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def rigidity_mask(w2c_a, w2c_b, flow, cam: R.Cam) -> torch.Tensor:
    """(H, W) bool: pixels of frame a whose flow to frame b keeps to the
    epipolar geometry of the two poses."""
    h, w = cam.height, cam.width
    dev = flow.device
    x, y = _grid(h, w, torch.float32, dev)
    x2, y2 = x + flow[0].reshape(-1), y + flow[1].reshape(-1)
    R_rel = w2c_b[:3, :3] @ w2c_a[:3, :3].T
    t_rel = w2c_b[:3, 3] - R_rel @ w2c_a[:3, 3]
    Kinv = torch.tensor([[1.0 / cam.fx, 0.0, -cam.cx / cam.fx],
                         [0.0, 1.0 / cam.fy, -cam.cy / cam.fy],
                         [0.0, 0.0, 1.0]], device=dev)
    F = Kinv.T @ _skew(t_rel) @ R_rel @ Kinv
    one = torch.ones_like(x)
    p1 = torch.stack([x, y, one], 1)
    p2 = torch.stack([x2, y2, one], 1)
    Fp1 = p1 @ F.T
    Ftp2 = p2 @ F
    num = torch.sum(p2 * Fp1, 1) ** 2
    den = Fp1[:, 0] ** 2 + Fp1[:, 1] ** 2 + Ftp2[:, 0] ** 2 + \
        Ftp2[:, 1] ** 2
    d = num / (den + 1e-8)
    inside = (x2 > 0) & (x2 < w) & (y2 > 0) & (y2 < h)
    d = torch.where(inside, d, torch.zeros_like(d))
    keep = d <= torch.mean(d) + 2.0 * torch.std(d, unbiased=False)
    return keep.reshape(h, w)


def _so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' rotation of an axis-angle vector (Taylor terms near 0)."""
    th2 = torch.sum(omega * omega)
    K = _skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    if float(th2) < 1e-8:
        a, b = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0
    else:
        th = torch.sqrt(th2)
        a, b = torch.sin(th) / th, (1.0 - torch.cos(th)) / th2
    return eye + a * K + b * (K @ K)


def gauss_newton(q0, t0, prev_depth, prev_w2c, flow, cam: R.Cam, mask, *,
                 iters: int = 8, huber_px: float = 2.0,
                 damping: float = 1e-4, min_weight: float = 64.0):
    """The refined pose (R (3, 3), t (3,)) from the init (q0, t0)."""
    h, w = cam.height, cam.width
    dev = flow.device
    z = prev_depth.float().reshape(-1)
    x, y = _grid(h, w, torch.float32, dev)
    cam_pts = torch.stack([(x - cam.cx) / cam.fx * z,
                           (y - cam.cy) / cam.fy * z, z], 1)
    c2w = invert(prev_w2c)
    world = cam_pts @ c2w[:3, :3].T + c2w[:3, 3]
    tx, ty = x + flow[0].reshape(-1), y + flow[1].reshape(-1)
    base = (z > 0) & mask.reshape(-1) & (tx > EDGE) & (tx < w - EDGE) & \
        (ty > EDGE) & (ty < h - EDGE)
    Rm = R.quat_rotmat(q0)
    t = t0.clone()
    for _ in range(iters):
        p = world @ Rm.T + t
        ok = base & (p[:, 2] > 1e-3)
        pz = torch.where(ok, p[:, 2], torch.ones_like(p[:, 2]))
        a, b = p[:, 0] / pz, p[:, 1] / pz
        ru = a * cam.fx + cam.cx - tx
        rv = b * cam.fy + cam.cy - ty
        rn = torch.sqrt(ru * ru + rv * rv + 1e-12)
        wt = torch.where(ok, torch.clamp_max(
            huber_px / torch.clamp_min(rn, 1e-12), 1.0), torch.zeros_like(rn))
        zero = torch.zeros_like(a)
        Ju = torch.stack([cam.fx / pz, zero, -cam.fx * a / pz,
                          -cam.fx * a * b, cam.fx * (1.0 + a * a),
                          -cam.fx * b], 1)
        Jv = torch.stack([zero, cam.fy / pz, -cam.fy * b / pz,
                          -cam.fy * (1.0 + b * b), cam.fy * a * b,
                          cam.fy * a], 1)
        H = (Ju * wt[:, None]).T @ Ju + (Jv * wt[:, None]).T @ Jv
        g = Ju.T @ (wt * ru) + Jv.T @ (wt * rv)
        H = H + damping * torch.diag(torch.diag(H)) + \
            1e-8 * torch.eye(6, device=dev)
        if float(torch.sum(wt)) < min_weight:
            continue
        step = -torch.linalg.solve(H, g)
        Rd = _so3(step[3:])
        Rm = Rd @ Rm
        t = Rd @ t + step[:3]
    return Rm, t


def flow_loss(prev_depth, prev_w2c, cur_w2c, flow, cam: R.Cam, mask):
    """The flow-projection loss; ``prev_depth`` in the cache's dtype, which
    the back-projection keeps."""
    h, w = cam.height, cam.width
    dev = flow.device
    xb, yb = _grid(h, w, prev_depth.dtype, dev)
    z = prev_depth.reshape(-1)
    pts = torch.stack([(xb - cam.cx) / cam.fx * z,
                       (yb - cam.cy) / cam.fy * z, z], -1)
    c2w = invert(prev_w2c)
    pts = pts.to(c2w.dtype) @ c2w[:3, :3].T + c2w[:3, 3]
    pc = pts @ cur_w2c[:3, :3].T + cur_w2c[:3, 3]
    zz = pc[:, 2:3] + 1e-5
    u = pc[:, 0:1] / zz * cam.fx + cam.cx
    v = pc[:, 1:2] / zz * cam.fy + cam.cy
    x, y = _grid(h, w, torch.float32, dev)
    du = u[:, 0] - x - flow[0].reshape(-1)
    dv = v[:, 0] - y - flow[1].reshape(-1)
    ok = (z > 0) & mask.reshape(-1) & (u[:, 0] > EDGE) & \
        (u[:, 0] < w - EDGE) & (v[:, 0] > EDGE) & (v[:, 0] < h - EDGE) & \
        (pc[:, 2] > 0)
    num = torch.sum(torch.where(ok, du.abs() + dv.abs(),
                                torch.zeros_like(du)))
    n = torch.sum(ok.float())
    return num / (2.0 * n + 1e-8) if float(n) > 0 else num * 0.0


def tracking_grads(params, active, q, t, cam: R.Cam, sh_degree, frame,
                   prev_depth, prev_w2c, flow, mask, cfg: dict,
                   drop_half_rows: bool = False):
    """(loss, dL/dq, dL/dt) of one tracking step at pose (q, t), the map
    frozen."""
    q = q.detach().requires_grad_(True)
    t = t.detach().requires_grad_(True)
    with torch.enable_grad():
        T = w2c(q, t)
        p, lay, out, _ = R.render(params, active, T, cam, sh_degree)
        img = out["image"].requires_grad_(True)
        m = ((img[3] > 0) & mask).to(img.dtype)
        a, b = img[0:3] * m, frame * m
        if drop_half_rows:
            half = a.shape[1] // 2
            a, b = a[:, :half], b[:, :half]
        rgb = 0.8 * torch.mean(torch.abs(a - b)) + 0.2 * (1.0 - M.ssim(a, b))
        fl = flow_loss(prev_depth, prev_w2c, T, flow, cam, mask)
        loss = cfg["w_rgb_tracking"] * rgb + cfg["w_flow_tracking"] * fl
        g_img, gq, gt = torch.autograd.grad(loss, (img, q, t),
                                            retain_graph=True,
                                            allow_unused=True)
        dfeat = R.composite_backward(p, lay, cam, g_img)
        rq, rt = torch.autograd.grad(R._features(p), (q, t), dfeat)
    gq = rq if gq is None else gq + rq
    gt = rt if gt is None else gt + rt
    return loss.detach(), gq, gt


def tracking_lr(i: int, total: int) -> float:
    third = max(total // 3, 1)
    return 0.01 * 0.5 ** (1 + min(i // third, 2))


def _adam(pose: dict, mu: dict, nu: dict, g: dict, i: int, total: int):
    """Step ``i`` of the tracking budget ``total``: the pose's Adam update
    by the gradient ``g`` (non-finite entries count as 0), in place."""
    bc1, bc2 = 1.0 - 0.9 ** (i + 1), 1.0 - 0.999 ** (i + 1)
    lr = tracking_lr(i, total)
    for k in pose:
        gk = torch.where(torch.isfinite(g[k]), g[k], torch.zeros_like(g[k]))
        mu[k] = 0.9 * mu[k] + 0.1 * gk
        nu[k] = 0.999 * nu[k] + 0.001 * gk * gk
        pose[k] = pose[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                                  + 1e-15)


def _zeros(pose: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in pose.items()}


def track_at(params, active, poses: list, cam: R.Cam, sh_degree, frame,
             prev_depth, prev_w2c, flow, mask, cfg: dict, *,
             mode: str = "fp32", drop_half_rows: bool = False,
             grad_scale: float = 1.0) -> dict:
    """The tracking loss at each of ``poses`` ((q, t) pairs), and its
    gradients by leaf at the first."""
    losses, first = [], None
    with M.precision(mode):
        for q, t in poses:
            loss, gq, gt = tracking_grads(
                params, active, q, t, cam, sh_degree, frame, prev_depth,
                prev_w2c, flow, mask, cfg, drop_half_rows)
            if first is None:
                first = {"q": gq * grad_scale, "t": gt * grad_scale}
            losses.append(float(loss))
    return {"losses": losses, "grad1": first}


def replay_tracking(q, t, grads: list, total: int) -> dict:
    """The pose that Adam makes from (q, t) with the given gradients, one
    (dL/dq, dL/dt) a step: where the whole tracking loop's gradients are
    the program's own, the pose its loop has to keep."""
    pose = {"q": q.clone(), "t": t.clone()}
    mu, nu = _zeros(pose), _zeros(pose)
    for i, (gq, gt) in enumerate(grads):
        _adam(pose, mu, nu, {"q": gq, "t": gt}, i, total)
    return pose


def follow_two_view(state: dict, schedule: list, seq, poses: dict,
                    cam: R.Cam, cfg: dict, *, mode: str = "fp32",
                    drop_half_rows: bool = False) -> dict:
    """Two-view mapping iterations from ``state`` (as ``mapping.follow``)
    over ``schedule``, a list of ((frame, rebin, boxes) of the current
    view, the same of the keyframe view); ``poses`` {frame: (4, 4)}."""
    params = {k: state["params"][k].clone() for k in M.LEAVES}
    mu = {k: v.clone() for k, v in state["mu"].items()}
    nu = {k: v.clone() for k, v in state["nu"].items()}
    count, it = state["count"], state["iteration"]
    losses, first = [], None
    carry = {"cur": None, "kf": None}
    with M.precision(mode):
        for views in schedule:
            total, grads = 0.0, None
            for name, (f, rebin, boxes) in zip(("cur", "kf"), views):
                if rebin:
                    carry[name] = None
                loss, g, carry[name] = M.step_grads(
                    params, state["active"], poses[f], cam,
                    state["sh_degree"], seq.colors[f], seq.prior[f], boxes,
                    cfg, carry[name], drop_half_rows)
                total = total + loss
                grads = g if grads is None else {k: grads[k] + g[k]
                                                 for k in M.LEAVES}
            it += 1
            params, mu, nu, count = M.adam(params, grads, mu, nu, count,
                                           M.learning_rates(cfg, it))
            losses.append(float(total))
            if first is None:
                first = grads
    return {"losses": losses, "grad1": first, "params": params}

