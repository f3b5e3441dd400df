#!/usr/bin/env python3
"""Step witness at full width: the JAX package and the port, step by step,
from one shared state, on the full-res recipe at 1280x1024 on the CPU.

    python tests/fullwidth_witness.py --work <dir> [--steps 1,2,3,4,5,6]
        [--map_iters 10] [--track_iters 4] [--threads 4]
        [--port_grad_sum direct|prefix]
        [--out results/fullwidth_witness.json]

The recipe's first 3 frames are made once by the port's
``cli.make_fullres_dataset --device cpu --frames 3`` (seed 7, 1280x1024,
20,000 Gaussians) into ``<work>/data``; both packages load that directory
with cfg34_r5c's settings (``--depth_prior metric --rebin_every 4
--tracking_gn_iters 8``). The JAX side runs on the CPU with its Pallas
kernels in interpret mode (``default_impl``), the port through the plain
versions of its kernels. From step 2 on, every step starts from the JAX
package's state, carried into the port by ``freesurgs_tpu_torch.convert``:

1. init: frame 0's field from ``from_rgbd`` in each package's Trainer
   (131,072 Gaussians), expected equal;
2. binning at frame 0's camera: JAX's ``compute_bin_state`` (the fast
   binner the TPU ran) against the port's sort binner, on JAX's
   projection and on each package's own; ``gather_idx``, ``tile_start``,
   ``tile_count``, ``num_instances`` equal exactly; repeated on step 4's
   state;
3. one render fwd+bwd of frame 0's mapping loss: channels within 2e-5 x
   max(1, |channel|), per-Gaussian gradients within 5e-5 normalized by
   the field's largest; each pixel beyond the gate composited again in
   float64;
4. frame 0's ``mapping_chunk`` for ``--map_iters`` iterations (the recipe
   runs 200), the local-Pearson boxes drawn from JAX's key chain and fed
   to the port: parameters at the Trainer gate (1e-3; 99% within 1e-5);
5. frame 1's tracking on step 4's state: ``flow_projection_loss`` alone at
   the start pose and at JAX's tracked pose (1e-3 px), then
   ``tracking_loop`` with 8 GN iterations and ``--track_iters`` Adam
   iterations (the recipe runs 50): pose (1e-5), flow_loss, rgb_loss,
   gn_resid_px (1e-4 relative), printed beside the full-scale runs'
   frame-1 rows; then, to find where the pose parts, the GN solve alone
   in each package from the identity, and each package's Adam
   iterations alone (GN off) from JAX's GN pose;
6. densify on step 4's state and accumulators with JAX's split noise
   (drawn from its key as ``freesurgs_tpu/train/densify.py`` does), then
   ``reset_opacity``: the clone / split / prune counts, the new active set
   and the parameters equal; Gaussians within 1e-6 (relative) of a
   threshold counted and listed.

Steps 3-5 also run the JAX side on its sort binner (``fast_binning``
off: each Gaussian's gradients summed by scatter-adds, not as a
difference of prefix sums over all instances), the JAX package against
itself under another per-Gaussian sum. ``--port_grad_sum prefix`` runs
the port with the JAX default's reduction (``TrainConfig.grad_sum``, every
render of steps 3-5), so its "port" columns read the port on the TPU
path's arithmetic. Cuts (iteration counts only,
never the width) are listed in the output.
Writes ``--out`` (each step's gate, worst error, counts and seconds) and
``<work>/witness_detail.json``; exits 1 if a step is beyond its gate.
Not collected by pytest (its name does not start with ``test_``). With 4
threads at 1280x1024 on an 8-core x86 CPU the whole run took 3,151 s,
frame 0's mapping 1,866 s of it (the ``seconds`` of each step are in the
output).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
HW, FRAMES, SEED = (1024, 1280), 3, 7
# cfg34_r5c's TrainConfig (scripts/run_config34.py, cli/run_config34.py)
CFG = dict(global_iters=30000, rebin_every=4, rebin_tracking_every=1,
           tracking_gn_iters=8, keyframe_policy="uniform")
RECIPE_ITERS = {"map_iters": 200, "track_iters": 50}
# frame 1's tracking rows of the full-scale runs: flow_loss / rgb_loss /
# gn_resid_px (PERF.md §6)
FRAME1_ROWS = {"tpu_v5e_cfg34_r5c": [0.0695, 0.0673, 0.4338],
               "port_h100_arm_a": [0.1193, 0.0680, 0.4327]}
PARAMS = ("means", "quats", "log_scales", "logit_opacity", "sh_dc",
          "sh_rest")
STATS = ("grad_accum", "grad_denom", "max_radii2d")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", required=True)
    ap.add_argument("--steps", default="1,2,3,4,5,6")
    ap.add_argument("--map_iters", type=int, default=10)
    ap.add_argument("--track_iters", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--port_grad_sum", default="direct",
                    choices=("direct", "prefix"),
                    help="the port's backward per-Gaussian reduction")
    ap.add_argument("--hw", type=int, nargs=2, default=list(HW),
                    help="height width; only a debugging run cuts it")
    ap.add_argument("--out", default=str(REPO / "results"
                                         / "fullwidth_witness.json"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    steps = sorted({int(s) for s in args.steps.split(",")})
    n = str(args.threads)
    os.environ.update(OMP_NUM_THREADS=n, JAX_PLATFORMS="cpu",
                      XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                                f"intra_op_parallelism_threads={n}")
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(args.threads)
    w = Witness(args)
    res = w.run(steps)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({k: {"within_gate": v["within_gate"],
                          "worst": v.get("worst")}
                      for k, v in res["steps"].items()}))
    return 0 if res["all_within_gates"] else 1


@contextlib.contextmanager
def jax_binner(fast: bool):
    """The JAX package's renders on its fast binner (``fast_binning``, the
    TPU run's) or on its sort binner: ``raster_config`` patched, and
    ``train/steps.py``'s ``render`` replaced by its unjitted body so that
    a fresh trace sees the patch (JAX's trace cache is keyed on the
    function traced, so each caller jits a new one)."""
    import freesurgs_tpu.ops.render as jrender_mod
    from freesurgs_tpu.train import steps as js
    real_cfg, real_render = jrender_mod.raster_config, js.render
    jrender_mod.raster_config = (
        lambda *a, **k: real_cfg(*a, **k)._replace(fast_binning=fast))
    js.render = real_render.__wrapped__
    try:
        yield
    finally:
        jrender_mod.raster_config, js.render = real_cfg, real_render


class Witness:
    """Both packages' Trainers on one dataset, and the step comparisons."""

    def __init__(self, args):
        import jax.numpy as jnp
        import numpy as np
        import torch

        from freesurgs_tpu.data.scared import load_scared as jload
        from freesurgs_tpu.train.loop import Trainer as JTrainer
        from freesurgs_tpu.train.steps import TrainConfig as JConfig
        from freesurgs_tpu_torch.cli import make_fullres_dataset
        from freesurgs_tpu_torch.data.scared import load_scared as tload
        from freesurgs_tpu_torch.train.loop import Trainer as TTrainer
        from freesurgs_tpu_torch.train.steps import TrainConfig as TConfig

        self.args, self.np, self.jnp, self.torch = args, np, jnp, torch
        self.t_start = time.time()
        work = Path(args.work).resolve()
        work.mkdir(parents=True, exist_ok=True)
        self.work = work
        data = work / "data"
        h, wd = args.hw
        if not (data / "poses").exists():
            make_fullres_dataset.main(
                ["--out", str(data), "--frames", str(FRAMES), "--seed",
                 str(SEED), "--hw", str(h), str(wd), "--device", "cpu"],
                log=self.log)
        self.cuts = [
            f"mapping_chunk: {args.map_iters} of the recipe's "
            f"{RECIPE_ITERS['map_iters']} frame-0 iterations",
            f"tracking_loop: {args.track_iters} of the recipe's "
            f"{RECIPE_ITERS['track_iters']} Adam iterations (GN's 8 kept)",
            f"frames: {FRAMES} of the recipe's 60 made"]
        if tuple(args.hw) != HW:
            self.cuts.append(f"width: {h}x{wd}, not {HW[0]}x{HW[1]} "
                             "(a debugging run, not the witness)")
        jseq = jload(str(data), 0, FRAMES, sample_rate=8,
                     depth_prior="metric")
        tseq = tload(str(data), 0, FRAMES, sample_rate=8,
                     depth_prior="metric")
        t0 = time.time()
        self.jt = JTrainer(jseq, JConfig(**CFG), global_chunk=250,
                           log_fn=self.log)
        self.tt = TTrainer(tseq, TConfig(**CFG,
                                         grad_sum=args.port_grad_sum),
                           global_chunk=250,
                           log_fn=self.log, device="cpu")
        self.init_s = time.time() - t0
        self.cam_j, self.cam_t = self.jt.cam, self.tt.cam

    # ------------------------------------------------------------ helpers
    def log(self, msg):
        print(f"[{time.time() - self.t_start:8.1f}s] {msg}", flush=True)

    def jnp_field(self, f) -> dict:
        np = self.np
        return {k: np.asarray(getattr(f, k)) for k in
                PARAMS + ("active",) + STATS + ("scene_radius",)}

    def port_field(self, arrays: dict, max_sh_degree: int):
        from freesurgs_tpu_torch.convert import field_from_numpy
        return field_from_numpy(arrays, device="cpu",
                                max_sh_degree=max_sh_degree)

    def port_state(self, jstate):
        """The port's MappingState from the JAX package's (field, Adam
        moments, iteration, bf16 caches); the generator is unused here
        (every draw is JAX's, fed in)."""
        from freesurgs_tpu_torch.convert import adam_from_numpy
        from freesurgs_tpu_torch.train.steps import MappingState
        np, torch = self.np, self.torch
        f = jstate.field
        opt = jstate.opt
        g = torch.Generator()
        g.manual_seed(SEED)

        def bf16(x):
            return torch.from_numpy(np.asarray(x).astype(np.float32)).to(
                torch.bfloat16)

        return MappingState(
            field=self.port_field(self.jnp_field(f), f.max_sh_degree),
            opt=adam_from_numpy({k: np.asarray(v) for k, v in opt.mu.items()},
                                {k: np.asarray(v) for k, v in opt.nu.items()},
                                int(opt.count), device="cpu"),
            iteration=int(jstate.iteration), generator=g,
            pred_depths=bf16(jstate.pred_depths),
            pred_colors=bf16(jstate.pred_colors))

    def t2n(self, x):
        return x.detach().to(self.torch.float32).numpy() \
            if x.dtype == self.torch.bfloat16 else x.detach().numpy()

    def trainer_gate(self, a, b) -> dict:
        """The Trainer gate: worst |a - b| <= 1e-3 and its 99th percentile
        <= 1e-5."""
        np = self.np
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        err = np.abs(a - b).ravel()
        worst = float(err.max()) if err.size else 0.0
        q99 = float(np.quantile(err, 0.99)) if err.size else 0.0
        return {"worst": worst, "q99": q99,
                "within_gate": worst <= 1e-3 and q99 <= 1e-5}

    # --------------------------------------------------------------- steps
    def step1(self) -> dict:
        np = self.np
        jf = self.jnp_field(self.jt.field)
        tf = self.tt.field
        out = {"gate": "equal (every array of the field)",
               "init_s_both_trainers": self.init_s,
               "num_active": [int(jf["active"].sum()),
                              int(tf.active.sum())],
               "capacity": [int(jf["active"].shape[0]), tf.capacity]}
        errs = {}
        for k in PARAMS + ("active",) + STATS + ("scene_radius",):
            a = np.asarray(jf[k], np.float64)
            b = np.asarray(self.t2n(getattr(tf, k)), np.float64)
            errs[k] = {"max_abs": float(np.abs(a - b).max()),
                       "unequal": int((a != b).sum())}
        out["fields"] = errs
        out["log_scales_vs_float64"] = self.knn_float64(
            jf, self.t2n(tf.log_scales))
        # the two loaders on the one directory (both packages' Trainers
        # keep f32 copies of its frames, priors and flows)
        out["inputs_unequal"] = {
            k: int((np.asarray(getattr(self.jt, k))
                    != self.t2n(getattr(self.tt, k))).sum())
            for k in ("colors", "monodeps", "flows_fw")}
        out["worst"] = max(e["max_abs"] for e in errs.values())
        out["within_gate"] = all(e["unequal"] == 0 for e in errs.values()) \
            and not any(out["inputs_unequal"].values())
        return out

    def knn_float64(self, jf: dict, t_log_scales, sample: int = 2048
                    ) -> dict:
        """Both packages' initial log-scales against a float64 evaluation
        of the same 3-nearest-neighbour mean on a sample of slots. Both
        compute |x|^2 + |y|^2 - 2 x.y in f32 (``ops/knn.py``), which
        cancels to the squared spacing of neighbouring Gaussians."""
        np = self.np
        act = np.flatnonzero(jf["active"])
        pts = jf["means"][act].astype(np.float64)
        rng = np.random.default_rng(SEED)
        pick = np.sort(rng.choice(act.size, min(sample, act.size),
                                  replace=False))
        ref = np.empty(pick.size)
        for i in range(0, pick.size, 64):
            q = pts[pick[i:i + 64]]
            d = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
            d[np.arange(q.shape[0]), pick[i:i + 64]] = np.inf
            ref[i:i + 64] = np.sort(np.partition(d, 3, axis=1)[:, :3],
                                    axis=1).mean(1)
        ref = 0.5 * np.log(np.maximum(ref, 1e-7))
        out = {"sample": int(pick.size)}
        for name, ls in (("jax", jf["log_scales"]), ("port", t_log_scales)):
            e = np.abs(ls[act[pick], 0].astype(np.float64) - ref)
            out[name] = {"max_abs": float(e.max()),
                         "median_abs": float(np.median(e))}
        return out

    def layouts(self, jfield, w2c) -> dict:
        """JAX's fast binner against the port's sort binner, on JAX's
        projection and on each package's own."""
        import jax
        np, jnp, torch = self.np, self.jnp, self.torch
        from freesurgs_tpu.core.transforms import transform_points
        from freesurgs_tpu.ops.projection import project_gaussians
        from freesurgs_tpu.ops.raster_pallas import compute_bin_state
        from freesurgs_tpu.ops.render import raster_config
        from freesurgs_tpu_torch.ops.binning import build_tile_bins, \
            derive_bin_rect
        from freesurgs_tpu_torch.ops.projection import ProjectedGaussians
        from freesurgs_tpu_torch.ops.raster_cuda import _prune_and_snug
        from freesurgs_tpu_torch.ops.render import render_records

        cam = self.cam_j
        n = jfield.means.shape[0]
        rcfg = raster_config(cam, self.jt.cfg.max_instances, n,
                             "pallas_interpret", 32)

        @jax.jit
        def jbin(f, w2c):
            proj = project_gaussians(transform_points(w2c, f.means),
                                     jnp.exp(f.log_scales), f.quats, cam,
                                     active=f.active)
            opac = jax.nn.sigmoid(f.logit_opacity)
            return proj, opac, compute_bin_state(proj, opac, rcfg)

        t0 = time.time()
        proj, opac, jb = jbin(jfield, jnp.asarray(w2c))
        jb = jax.tree.map(np.asarray, jb)
        t_j = time.time() - t0
        gx, gy = rcfg.grid_x, rcfg.grid_y
        t0 = time.time()
        tproj = ProjectedGaussians(*(torch.from_numpy(np.array(x))
                                     for x in proj))
        same = build_tile_bins(derive_bin_rect(_prune_and_snug(
            tproj, torch.from_numpy(np.array(opac))), 2), gx, gy,
            self.tt.cfg.instance_cap)
        tf = self.port_field(self.jnp_field(jfield), jfield.max_sh_degree)
        _, _, _, own = render_records(
            tf.means, tf.quats, tf.log_scales, tf.logit_opacity, tf.sh,
            torch.from_numpy(np.asarray(w2c, np.float32)), self.cam_t,
            active=tf.active, sh_degree=0,
            max_instances=self.tt.cfg.instance_cap)
        t_t = time.time() - t0

        def cmp(tb) -> dict:
            m = tb.gather_idx.shape[0]
            gi = tb.gather_idx.numpy()
            jg = jb.gather_idx
            pad_ok = bool((jg[m:] == n).all()) if jg.shape[0] >= m else False
            k = min(m, jg.shape[0])
            return {"slots": [int(jg.shape[0]), m],
                    "num_instances": [int(jb.num_instances),
                                      int(tb.num_instances)],
                    "overflow": [int(jb.overflow), int(tb.overflow)],
                    "gather_idx_unequal": int((jg[:k] != gi[:k]).sum())
                    + abs(m - k),
                    "jax_tail_is_padding": pad_ok,
                    "tile_start_unequal": int((jb.tile_start
                                               != tb.tile_start.numpy()
                                               ).sum()),
                    "tile_count_unequal": int((jb.tile_count
                                               != tb.tile_count.numpy()
                                               ).sum())}

        res = {"tiles": gx * gy, "gaussians": n,
               "same_projection": cmp(same), "own_projection": cmp(own),
               "seconds": {"jax": t_j, "port": t_t}}

        def exact(c):
            return (c["gather_idx_unequal"] == 0 and c["jax_tail_is_padding"]
                    and c["tile_start_unequal"] == 0
                    and c["tile_count_unequal"] == 0
                    and c["num_instances"][0] == c["num_instances"][1]
                    and c["overflow"] == [0, 0])

        res["within_gate"] = exact(res["same_projection"]) and exact(
            res["own_projection"])
        return res

    def step2(self, jstate, tag) -> dict:
        out = self.layouts(jstate.field, self.np.eye(4, dtype="float32"))
        out["gate"] = ("gather_idx, tile_start, tile_count, num_instances "
                       "equal exactly")
        out["state"] = tag
        c = out["own_projection"]
        out["worst"] = c["gather_idx_unequal"] + c["tile_start_unequal"] \
            + c["tile_count_unequal"]
        return out

    def step3(self, jstate) -> dict:
        """One render fwd+bwd of frame 0's mapping loss with the densify
        probe, on JAX's fast binner (the TPU run's;
        its backward sums each Gaussian's instance gradients as a
        difference of two f32 prefix sums over all instances) and on its
        sort binner (a scatter-add per Gaussian), against the port's."""
        import jax
        np, jnp, torch = self.np, self.jnp, self.torch
        import freesurgs_tpu.ops.render as jrender_mod
        from freesurgs_tpu_torch.ops.render import render as trender
        from freesurgs_tpu.train import losses as jlosses
        from freesurgs_tpu_torch.train import losses as tlosses
        f = jstate.field
        h, wd = self.cam_j.height, self.cam_j.width
        chans = ("render", "render_dep", "render_sil", "final_T")
        w2c = np.eye(4, dtype=np.float32)
        act = f.active
        maxi = self.jt.cfg.max_instances
        cam, cfg = self.cam_j, self.jt.cfg
        gt, mono = self.jt.colors[0], self.jt.monodeps[0]
        # the first mapping iteration's local-Pearson key and its corners
        k_lp = jax.random.split(jstate.key, 4)[2]
        (bx, by), = self.lp_boxes(jstate.key, 1)[0]
        probe = np.zeros((f.capacity, 2), np.float32)
        args = (f.means, f.quats, f.log_scales, f.logit_opacity, f.sh,
                jnp.asarray(probe))
        names = ("means", "quats", "log_scales", "logit_opacity", "sh",
                 "probe2d")
        render_py = jrender_mod.render.__wrapped__    # traced anew below

        def jax_run(fast: bool):
            """fwd+bwd of frame 0's mapping loss (rgb, Pearson, local
            Pearson) on the binner asked."""
            def jl(m, q, s, o, c, p):
                out = render_py(
                    m, q, s, o, c, jnp.asarray(w2c), cam, active=act,
                    probe2d=p, sh_degree=0, impl="pallas_interpret",
                    max_instances=maxi)
                loss = (cfg.w_rgb_mapping
                        * jlosses.rgb_loss(out["render"], gt)
                        + cfg.w_pearson * jlosses.pearson_depth_loss(
                            mono, out["render_dep"])
                        + cfg.w_local_pearson * jlosses.local_pearson_loss(
                            mono, out["render_dep"], k_lp))
                return loss, {k: out[k] for k in chans}

            with jax_binner(fast):
                t0 = time.time()
                (_, jo), jg = jax.jit(jax.value_and_grad(
                    jl, argnums=tuple(range(6)), has_aux=True))(*args)
                jo = {k: np.asarray(v) for k, v in jo.items()}
                jg = [np.asarray(g) for g in jg]
            return jo, jg, time.time() - t0

        jo, jg, t_j = jax_run(True)
        _, jg_sort, t_js = jax_run(False)
        t0 = time.time()
        ts_ = [torch.from_numpy(np.array(x)).requires_grad_(True)
               for x in args]
        to = trender(*ts_[:5], torch.from_numpy(w2c), self.cam_t,
                     active=torch.from_numpy(np.asarray(act)),
                     probe2d=ts_[5], sh_degree=0,
                     max_instances=self.tt.cfg.instance_cap,
                     grad_sum=self.tt.cfg.grad_sum)
        gt_t = torch.from_numpy(np.asarray(gt))
        mono_t = torch.from_numpy(np.asarray(mono))
        tcfg = self.tt.cfg
        (tcfg.w_rgb_mapping * tlosses.rgb_loss(to["render"], gt_t)
         + tcfg.w_pearson * tlosses.pearson_depth_loss(
             mono_t, to["render_dep"])
         + tcfg.w_local_pearson * tlosses.local_pearson_loss(
             mono_t, to["render_dep"], torch.from_numpy(bx.astype(np.int64)),
             torch.from_numpy(by.astype(np.int64)))).backward()
        tg = [t.grad.numpy() for t in ts_]
        t_t = time.time() - t0
        ch, beyond = {}, np.zeros((h, wd), bool)
        for k in chans:
            a, b = jo[k], self.t2n(to[k])
            e = np.abs(a - b) / np.maximum(1.0, np.abs(a))
            ch[k] = float(e.max())
            beyond |= (e > 2e-5).reshape(-1, h, wd).any(0)
        pix = self.pixel_reference(jstate.field, beyond, jo, to)

        def norm_err(ga, gb):
            return {nm: float(np.abs(a - b).max()
                              / max(float(np.abs(a).max()), 1e-30))
                    for nm, a, b in zip(names, ga, gb)}

        # the densify statistic of one view: |probe gradient| in half-NDC
        # units against the 2e-4 threshold, per visible Gaussian
        half_ndc = np.asarray([0.5 * wd, 0.5 * h], np.float32)
        thr = self.jt.cfg.densify.grad_threshold
        act_np = np.asarray(act)
        stat = {k: np.linalg.norm(g[-1] * half_ndc, axis=-1)[act_np]
                for k, g in (("jax_fast", jg), ("jax_sort", jg_sort),
                             ("port", tg))}

        def stat_cmp(a, b):
            d = np.abs(stat[a] - stat[b])
            return {"max_abs_over_threshold": float(d.max() / thr),
                    "gaussians_over_1pct_of_threshold": int(
                        (d > 0.01 * thr).sum()),
                    "threshold_side_differs": int(
                        ((stat[a] >= thr) != (stat[b] >= thr)).sum())}

        def grad_quantiles(ga, gb):
            """Per Gaussian, the largest normalized error over its
            components: quantiles and the count beyond 5e-5."""
            out = {}
            for nm, a, b in zip(names, ga, gb):
                e = (np.abs(a - b) / max(float(np.abs(a).max()), 1e-30)
                     ).reshape(a.shape[0], -1).max(1)[np.asarray(act)]
                out[nm] = {"q99": float(np.quantile(e, 0.99)),
                           "q999": float(np.quantile(e, 0.999)),
                           "beyond_5e-5": int((e > 5e-5).sum())}
            return out

        gr = norm_err(jg, tg)
        return {"gate": "channels 2e-5 x max(1, |channel|); gradients 5e-5 "
                        "normalized per field (JAX's fast binner, as the "
                        "TPU ran, against the port)",
                "channels": ch, "gradients": gr,
                "pixels_beyond_gate": pix,
                "gradient_quantiles": grad_quantiles(jg, tg),
                "gradients_jax_sort_binner_vs_port": norm_err(jg_sort, tg),
                "gradients_jax_fast_vs_sort_binner": norm_err(jg, jg_sort),
                "densify_statistic": {
                    "gaussians_over_threshold": {
                        k: int((v >= thr).sum()) for k, v in stat.items()},
                    "jax_fast_vs_port": stat_cmp("jax_fast", "port"),
                    "jax_sort_vs_port": stat_cmp("jax_sort", "port"),
                    "jax_fast_vs_sort": stat_cmp("jax_fast", "jax_sort")},
                "num_instances": int(to["num_instances"]),
                "worst": max(max(ch.values()) / 2e-5,
                             max(gr.values()) / 5e-5),
                "within_gate": max(ch.values()) <= 2e-5
                and max(gr.values()) <= 5e-5,
                "seconds": {"jax_fast": t_j, "jax_sort": t_js,
                            "port": t_t}}

    def pixel_reference(self, jfield, beyond, jo, to, worst: int = 200
                        ) -> dict:
        """The pixels where the channels part beyond the gate, each
        composited again in float64 from JAX's projected records and its
        layout (the compositing contract: alpha = min(0.99, o exp(power)),
        skipped below 1/255 or when power > 0, stop before the pair that
        takes T below 1e-4). For the ``worst`` of them: the float64
        channels beside JAX's and the port's, and the smallest relative
        margin of any pair before the stop to the 1/255 cutoff, and of the
        stopping pair to T = 1e-4 (a pair within f32 rounding of a cutoff
        is composited by one package and skipped by the other)."""
        import jax
        np, jnp = self.np, self.jnp
        from freesurgs_tpu.core.sh import sh_to_rgb_clamped
        from freesurgs_tpu.core.transforms import transform_points
        from freesurgs_tpu.ops.projection import project_gaussians
        from freesurgs_tpu.ops.raster_pallas import _prune_and_snug, \
            compute_bin_state
        from freesurgs_tpu.ops.render import raster_config

        h, wd = self.cam_j.height, self.cam_j.width
        n_beyond = int(beyond.sum())
        out = {"count": n_beyond, "fraction": n_beyond / (h * wd)}
        if not n_beyond:
            return out
        cam = self.cam_j
        rcfg = raster_config(cam, self.jt.cfg.max_instances,
                             jfield.capacity, "pallas_interpret", 32)

        @jax.jit
        def records(f):
            proj = project_gaussians(transform_points(jnp.eye(4), f.means),
                                     jnp.exp(f.log_scales), f.quats, cam,
                                     active=f.active)
            opac = jax.nn.sigmoid(f.logit_opacity)
            n2 = jnp.sum(f.means * f.means, axis=-1, keepdims=True)
            dirs = f.means * jax.lax.rsqrt(jnp.maximum(n2, 1e-16))
            rgb = sh_to_rgb_clamped(0, f.sh, dirs)
            pb = _prune_and_snug(proj, opac)
            return pb, rgb, opac, compute_bin_state(proj, opac, rcfg)

        pb, rgb, opac, bins = jax.tree.map(np.asarray, records(jfield))
        f64 = np.float64
        m2 = pb.mean2d.astype(f64)
        con = pb.conic.astype(f64)
        op = opac.astype(f64)
        col = np.concatenate([rgb, pb.depth[:, None]], 1).astype(f64)
        err = np.zeros((h, wd))
        for k in ("render", "render_dep", "final_T"):
            e = np.abs(jo[k] - self.t2n(to[k])).reshape(-1, h, wd).max(0)
            err = np.maximum(err, e)
        ys, xs = np.nonzero(beyond)
        order = np.argsort(-err[ys, xs])[:worst]
        rows = []
        for y, x in zip(ys[order], xs[order]):
            t = (y // 32) * rcfg.grid_x + x // 32
            st, cnt = int(bins.tile_start[t]), int(bins.tile_count[t])
            g = bins.gather_idx[st:st + cnt]
            r16 = pb.tile_rect[g]
            inr = ((x // 16 >= r16[:, 0]) & (x // 16 < r16[:, 2])
                   & (y // 16 >= r16[:, 1]) & (y // 16 < r16[:, 3]))
            g = g[inr]
            dx = m2[g, 0] - x
            dy = m2[g, 1] - y
            a_, b_, c_ = con[g, 0], con[g, 1], con[g, 2]
            power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
            raw = op[g] * np.exp(power)
            alpha = np.minimum(0.99, raw)
            ok = (power <= 0) & (alpha >= 1 / 255)
            a = np.where(ok, alpha, 0.0)
            T_before = np.concatenate([[1.0], np.cumprod(1 - a)[:-1]])
            stop = np.flatnonzero(ok & (T_before * (1 - a) < 1e-4))
            k_stop = int(stop[0]) if stop.size else a.size
            w = (a * T_before)[:k_stop]
            c64 = (w[:, None] * col[g[:k_stop]]).sum(0)
            T_fin = T_before[k_stop] if k_stop < a.size else (
                T_before[-1] * (1 - a[-1]) if a.size else 1.0)
            live = np.arange(a.size) <= k_stop
            cut = np.abs(raw * 255 - 1)[live & (power <= 0)]
            m_cut = float(cut.min()) if cut.size else None
            m_stop = (float(abs(T_before[k_stop] * (1 - a[k_stop]) / 1e-4
                                - 1)) if k_stop < a.size else None)
            bg = 1.0                       # white background
            ref = [c64[0] + T_fin * bg, c64[3] + T_fin * bg, T_fin]
            rows.append({
                "pixel": [int(x), int(y)], "pairs": int(a.size),
                "stop": k_stop,
                "float64": ref,
                "jax": [float(jo["render"][0, y, x]),
                        float(jo["render_dep"][y, x]),
                        float(jo["final_T"][y, x])],
                "port": [float(self.t2n(to["render"])[0, y, x]),
                         float(self.t2n(to["render_dep"])[y, x]),
                         float(self.t2n(to["final_T"])[y, x])],
                "margin_alpha_cutoff": m_cut, "margin_stop": m_stop})
        jerr = [max(abs(a - b) for a, b in zip(r["jax"], r["float64"]))
                for r in rows]
        terr = [max(abs(a - b) for a, b in zip(r["port"], r["float64"]))
                for r in rows]
        margins = [min(m for m in (r["margin_alpha_cutoff"],
                                   r["margin_stop"]) if m is not None)
                   for r in rows]
        out.update({
            "worst_examined": len(rows),
            "jax_vs_float64_max": float(max(jerr)),
            "port_vs_float64_max": float(max(terr)),
            "port_closer_to_float64": int(sum(t < j for j, t in
                                              zip(jerr, terr))),
            "jax_closer_to_float64": int(sum(j < t for j, t in
                                             zip(jerr, terr))),
            "cutoff_margin_max_over_examined": float(max(margins)),
            # every pixel beyond the gate examined, each with a pair
            # within 1e-5 (relative) of a cutoff in float64
            "all_explained_by_cutoffs": len(rows) == n_beyond
            and max(margins) <= 1e-5,
            "pixels": rows[:20]})
        return out

    def lp_boxes(self, key, n_iters: int):
        """The local-Pearson corners of a one-view chunk's iterations,
        drawn from JAX's key chain as ``mapping_chunk`` splits it
        (``freesurgs_tpu/train/steps.py``, ``losses.local_pearson_loss``),
        and the key the chunk ends with."""
        import jax
        jnp = self.jnp
        h, wd = self.cam_j.height, self.cam_j.width
        box = min(128, h, wd)
        nb = max(int(0.5 * (h // box) * (wd // box)), 1)
        boxes = []
        for _ in range(n_iters):
            key, _, k_lp1, _ = jax.random.split(key, 4)
            kx, ky = jax.random.split(k_lp1)
            boxes.append((jax.random.randint(kx, (nb,), 0, max(h - box, 1)),
                          jax.random.randint(ky, (nb,), 0,
                                             max(wd - box, 1))))
            key, _ = jax.random.split(key)          # densify's key
        return [(self.np.asarray(x), self.np.asarray(y)) for x, y in boxes], \
            key

    def jax_mapping(self, snap, k: int, fast: bool = True):
        """JAX's ``mapping_chunk`` of k frame-0 iterations from a numpy
        snapshot of its state: the Trainer's jitted call (the fast binner,
        as the TPU ran), or with the sort binner (``fast=False``, a fresh
        trace with ``raster_config`` patched): the JAX package against
        itself under another per-Gaussian gradient sum."""
        import jax
        jnp = self.jnp
        from freesurgs_tpu.train import steps as js
        jt = self.jt
        state = jax.tree.map(jnp.asarray, snap)
        args = (state, jt.colors, jt.monodeps,
                jax.lax.stop_gradient(jt.poses.all_w2c()),
                jnp.zeros((k,), jnp.int32),
                jnp.zeros((jt.num_frames,), jnp.int32), jnp.int32(1))
        kw = dict(cam=jt.cam, cfg=jt.cfg, two_views=False, sh_degree=0,
                  densify_enabled=True, mesh=None)
        t0 = time.time()
        if fast:
            out, aux = jt._mapping(*args, **kw)
        else:
            def fresh(*a, **k_):
                return js.mapping_chunk(*a, **k_)

            with jax_binner(False):
                out, aux = jax.jit(fresh, static_argnames=(
                    "cam", "cfg", "two_views", "sh_degree",
                    "densify_enabled", "mesh"))(*args, **kw)
        jax.block_until_ready(out.field.means)
        return out, aux, time.time() - t0

    def step4(self, snap):
        import jax
        np, torch = self.np, self.torch
        from freesurgs_tpu_torch.train import losses as tlosses
        from freesurgs_tpu_torch.train import steps as ts
        k = self.args.map_iters
        jstate = jax.tree.map(self.jnp.asarray, snap)
        tstate = self.port_state(jstate)
        boxes, key_end = self.lp_boxes(jstate.key, k)
        js_out, jaux, t_j = self.jax_mapping(snap, k)
        jsort, _, t_js = self.jax_mapping(snap, k, fast=False)
        jt = self.jt

        feed = iter(boxes)
        real = tlosses.local_pearson_boxes

        def jax_boxes(h, wd, gen, device=None):
            x, y = next(feed)
            return (torch.from_numpy(x.astype(np.int64)),
                    torch.from_numpy(y.astype(np.int64)))

        tt = self.tt
        t0 = time.time()
        tlosses.local_pearson_boxes = jax_boxes
        try:
            ts_out, taux = ts.mapping_chunk(
                tstate, torch.from_numpy(np.asarray(jt.colors)),
                torch.from_numpy(np.asarray(jt.monodeps)),
                tt.poses.all_w2c().detach(),
                [0] * k, [], tt.cam, tt.cfg, two_views=False, sh_degree=0,
                densify_enabled=True)
        finally:
            tlosses.local_pearson_boxes = real
        t_t = time.time() - t0
        jf, tf = js_out.field, ts_out.field
        params = {p: self.trainer_gate(getattr(jf, p),
                                       self.t2n(getattr(tf, p)))
                  for p in PARAMS}
        floor = {p: self.trainer_gate(getattr(jf, p),
                                      getattr(jsort.field, p))
                 for p in PARAMS}
        port_vs_sort = {p: self.trainer_gate(getattr(jsort.field, p),
                                             self.t2n(getattr(tf, p)))
                        for p in PARAMS}
        thr = self.jt.cfg.densify.grad_threshold

        def hot(accum, denom, active):
            a = np.asarray(accum, np.float64)
            d = np.asarray(denom, np.float64)
            return np.asarray(active) & (np.where(
                d > 0, a / np.maximum(d, 1.0), 0.0) >= thr)

        h_j, h_s = (hot(f.grad_accum, f.grad_denom, f.active)
                    for f in (jf, jsort.field))
        h_t = hot(self.t2n(tf.grad_accum), self.t2n(tf.grad_denom),
                  tf.active.numpy())
        densify_hot = {"over_threshold": {"jax_fast": int(h_j.sum()),
                                          "jax_sort": int(h_s.sum()),
                                          "port": int(h_t.sum())},
                       "differ_jax_fast_vs_port": int((h_j != h_t).sum()),
                       "differ_jax_fast_vs_sort": int((h_j != h_s).sum()),
                       "differ_jax_sort_vs_port": int((h_s != h_t).sum())}
        stats = {}
        for s in STATS:
            a = np.asarray(getattr(jf, s), np.float64)
            b = self.t2n(getattr(tf, s)).astype(np.float64)
            stats[s] = {"max_abs": float(np.abs(a - b).max()),
                        "max_rel": float((np.abs(a - b) / np.maximum(
                            np.abs(a), 1e-12)).max()),
                        "unequal": int((a != b).sum())}
        caches = {}
        for name in ("pred_depths", "pred_colors"):
            a = np.asarray(getattr(js_out, name)[0]).astype(np.float32)
            b = self.t2n(getattr(ts_out, name)[0])
            caches[name] = {"max_abs": float(np.abs(a - b).max()),
                            "unequal": int((a != b).sum())}
        scal = {"loss": [float(jaux["loss"]), float(taux["loss"])],
                "loss_terms": [np.asarray(jaux["loss_terms"]).tolist(),
                               self.t2n(taux["loss_terms"]).tolist()],
                "num_instances_max": [float(jaux["num_instances_max"]),
                                      float(taux["num_instances_max"])],
                "iteration": [int(js_out.iteration), ts_out.iteration],
                "num_active": [int(jf.num_active), int(tf.num_active)]}
        key_ok = bool((np.asarray(key_end) == np.asarray(js_out.key)).all())
        out = {"gate": "Trainer gate: worst 1e-3, 99% of entries 1e-5, per "
                       "parameter",
               "iterations": k, "params": params,
               "floor_jax_fast_vs_jax_sort_binner": floor,
               "port_vs_jax_sort_binner": port_vs_sort,
               "densify_over_threshold": densify_hot,
               "densify_stats": stats,
               "caches": caches, "scalars": scal,
               "lp_boxes_from_jax_key_chain": key_ok,
               "worst": max(v["worst"] for v in params.values()),
               "within_gate": all(v["within_gate"] for v in params.values())
               and key_ok,
               # how many times further JAX's fast binner is from its
               # sort binner than the port is (99th percentiles)
               "q99_fast_vs_sort_over_port_vs_sort": {
                   p: floor[p]["q99"] / max(port_vs_sort[p]["q99"], 1e-12)
                   for p in PARAMS},
               "seconds": {"jax": t_j, "jax_sort": t_js, "port": t_t}}
        return out, js_out, ts_out

    def step5(self, jstate) -> dict:
        import jax
        np, jnp, torch = self.np, self.jnp, self.torch
        from freesurgs_tpu.train import losses as jlosses
        from freesurgs_tpu.train.steps import make_jitted_tracking
        from freesurgs_tpu_torch.train import losses as tlosses
        from freesurgs_tpu_torch.train import steps as ts
        jt, tt = self.jt, self.tt
        tf = self.port_field(self.jnp_field(jstate.field),
                             jstate.field.max_sh_degree)
        prev_depth_j = jstate.pred_depths[0]               # bf16, frame 0
        prev_depth_t = torch.from_numpy(np.asarray(prev_depth_j).astype(
            np.float32)).to(torch.bfloat16)
        eye = np.eye(4, dtype=np.float32)
        q0 = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
        t0_ = np.zeros(3, np.float32)
        rigid = np.ones((self.cam_j.height, self.cam_j.width), np.float32)
        flow = np.asarray(jt.flows_fw[0])

        def flow_losses(w2c):
            j = float(jax.jit(jlosses.flow_projection_loss,
                              static_argnames=("cam",))(
                prev_depth_j, jnp.asarray(eye), jnp.asarray(w2c),
                jnp.asarray(flow), cam=self.cam_j,
                rigid_mask=jnp.asarray(rigid)))
            t = float(tlosses.flow_projection_loss(
                prev_depth_t, torch.from_numpy(eye), torch.from_numpy(w2c),
                torch.from_numpy(flow), self.cam_t,
                rigid_mask=torch.from_numpy(rigid)))
            return [j, t]

        cfg_j = jt.cfg._replace(tracking_iters=self.args.track_iters)
        cfg_t = tt.cfg._replace(tracking_iters=self.args.track_iters)
        t1 = time.time()
        jq, jtr, jm = make_jitted_tracking(self.cam_j, cfg_j)(
            jstate.field, jnp.asarray(q0), jnp.asarray(t0_), jt.colors[1],
            prev_depth_j, jnp.asarray(eye), jnp.asarray(flow),
            jnp.asarray(rigid), self.cam_j, cfg_j, sh_degree=0)
        jq, jtr = np.asarray(jq), np.asarray(jtr)
        t_j = time.time() - t1
        from freesurgs_tpu.train import steps as js

        def fresh(*a, **k_):
            return js.tracking_loop(*a, **k_)

        with jax_binner(False):
            sq, s_tr, _ = jax.jit(fresh, static_argnames=(
                "cam", "cfg", "sh_degree", "mesh"))(
                jstate.field, jnp.asarray(q0), jnp.asarray(t0_),
                jt.colors[1], prev_depth_j, jnp.asarray(eye),
                jnp.asarray(flow), jnp.asarray(rigid), cam=self.cam_j,
                cfg=cfg_j, sh_degree=0)
        sq, s_tr = np.asarray(sq), np.asarray(s_tr)
        t1 = time.time()
        tq, ttr, tm = ts.tracking_loop(
            tf, torch.from_numpy(q0), torch.from_numpy(t0_),
            torch.from_numpy(np.asarray(jt.colors[1])),
            prev_depth_t, torch.from_numpy(eye), torch.from_numpy(flow),
            torch.from_numpy(rigid), self.cam_t, cfg_t, sh_degree=0)
        t_t = time.time() - t1
        from freesurgs_tpu.core.transforms import build_w2c
        w2c_tracked = np.asarray(build_w2c(jnp.asarray(jq),
                                           jnp.asarray(jtr)))
        fl = {"start_pose": flow_losses(eye),
              "jax_tracked_pose": flow_losses(w2c_tracked)}
        rows = {k: [float(jm[k]), float(tm[k])]
                for k in ("flow_loss", "rgb_loss", "gn_resid_px", "loss")
                if k in jm and k in tm}
        def pose_diff(qa, ta, qb, tb):
            return max(float(np.abs(qa - qb).max()),
                       float(np.abs(ta - tb).max()))

        pose_err = pose_diff(jq, jtr, self.t2n(tq), self.t2n(ttr))
        flow_err = max(abs(a - b) for a, b in fl.values())
        split = self.step5_split(jstate, tf, prev_depth_j, prev_depth_t,
                                 eye, rigid, flow, cfg_j, cfg_t)
        rel = {k: abs(a - b) / max(abs(a), 1e-12) for k, (a, b) in
               rows.items()}
        return {"gate": "flow_projection_loss 1e-3 px; tracking_loop pose "
                        "1e-5 absolute, losses 1e-4 relative (the Trainer "
                        "tests' pose and loss gates)",
                "flow_projection_loss": fl,
                "tracking": {"pose_max_abs": pose_err,
                             "pose_max_abs_port_vs_jax_sort_binner":
                             pose_diff(sq, s_tr, self.t2n(tq),
                                       self.t2n(ttr)),
                             "pose_max_abs_jax_fast_vs_sort_binner":
                             pose_diff(jq, jtr, sq, s_tr),
                             "rows": rows,
                             "quat": [jq.tolist(), self.t2n(tq).tolist()],
                             "trans": [jtr.tolist(),
                                       self.t2n(ttr).tolist()],
                             "split": split},
                "full_scale_frame1_rows": FRAME1_ROWS,
                "worst": max(flow_err / 1e-3, pose_err / 1e-5,
                             max(rel.values()) / 1e-4),
                "within_gate": flow_err <= 1e-3 and pose_err <= 1e-5
                and max(rel.values()) <= 1e-4,
                "seconds": {"jax": t_j, "port": t_t}}

    def step5_split(self, jstate, tf, prev_depth_j, prev_depth_t, eye,
                    rigid, flow, cfg_j, cfg_t) -> dict:
        """Where frame 1's tracked pose parts: the Gauss-Newton flow-PnP
        solve alone in each package from the identity, then each
        package's Adam iterations (GN off) from JAX's GN pose."""
        import jax
        np, jnp, torch = self.np, self.jnp, self.torch
        from freesurgs_tpu.train.flow_pnp import flow_pnp_refine as jgn
        from freesurgs_tpu.train.steps import make_jitted_tracking
        from freesurgs_tpu_torch.train.flow_pnp import flow_pnp_refine as tgn
        from freesurgs_tpu_torch.train import steps as ts
        q0 = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
        t0_ = np.zeros(3, np.float32)
        gn = dict(iters=cfg_j.tracking_gn_iters,
                  huber_px=cfg_j.tracking_gn_huber_px)
        jq, jtr, jd = jax.jit(jgn, static_argnames=(
            "cam", "iters", "huber_px"))(
            jnp.asarray(q0), jnp.asarray(t0_), prev_depth_j,
            jnp.asarray(eye), jnp.asarray(flow), cam=self.cam_j,
            rigid_mask=jnp.asarray(rigid), **gn)
        tq, ttr, td = tgn(
            torch.from_numpy(q0), torch.from_numpy(t0_), prev_depth_t,
            torch.from_numpy(eye), torch.from_numpy(flow), self.cam_t,
            rigid_mask=torch.from_numpy(rigid), **gn)
        jq, jtr = np.asarray(jq), np.asarray(jtr)
        after_gn = {"quat": float(np.abs(jq - self.t2n(tq)).max()),
                    "trans": float(np.abs(jtr - self.t2n(ttr)).max()),
                    "gn_resid_px": [float(jd[0]), float(td[0])]}
        cj = cfg_j._replace(tracking_gn_iters=0)
        ct = cfg_t._replace(tracking_gn_iters=0)
        aq, atr, _ = make_jitted_tracking(self.cam_j, cj)(
            jstate.field, jnp.asarray(jq), jnp.asarray(jtr), self.jt.colors[1],
            prev_depth_j, jnp.asarray(eye), jnp.asarray(flow),
            jnp.asarray(rigid), self.cam_j, cj, sh_degree=0)
        bq, btr, _ = ts.tracking_loop(
            tf, torch.from_numpy(jq), torch.from_numpy(jtr),
            torch.from_numpy(np.asarray(self.jt.colors[1])), prev_depth_t,
            torch.from_numpy(eye), torch.from_numpy(flow),
            torch.from_numpy(rigid), self.cam_t, ct, sh_degree=0)
        aq, atr = np.asarray(aq), np.asarray(atr)
        adam = {"quat": float(np.abs(aq - self.t2n(bq)).max()),
                "trans": float(np.abs(atr - self.t2n(btr)).max()),
                "moved_from_gn_pose": float(max(np.abs(aq - jq).max(),
                                                np.abs(atr - jtr).max()))}
        return {"gn_alone_from_identity": after_gn,
                "adam_alone_from_jax_gn_pose": adam}

    def step6(self, jstate, tstate_own) -> dict:
        import jax
        np, jnp, torch = self.np, self.jnp, self.torch
        from freesurgs_tpu.train.densify import densify_and_prune as jdens, \
            reset_opacity as jreset
        from freesurgs_tpu_torch.train.densify import densify_and_prune as \
            tdens, reset_opacity as treset
        jt, tt = self.jt, self.tt
        f, opt = jstate.field, jstate.opt
        c = f.capacity
        _, k_dens = jax.random.split(jstate.key)
        # freesurgs_tpu/train/densify.py: k1, k2 = split(key); normal(k1)
        noise = np.asarray(jax.random.normal(jax.random.split(k_dens)[0],
                                             (2, c, 3)))
        gate_on = False       # iteration <= size_threshold_from here
        t1 = time.time()
        jf2, jo2, jst = jax.jit(jdens, static_argnames=(
            "cfg", "use_screen_size"))(f, opt, k_dens, cfg=jt.cfg.densify,
                                       use_screen_size=gate_on)
        jf3, jo3 = jax.jit(jreset)(jf2, jo2)
        t_j = time.time() - t1
        tstate = self.port_state(jstate)
        t1 = time.time()
        tf2, to2, tst = tdens(tstate.field, tstate.opt,
                              torch.from_numpy(noise), tt.cfg.densify,
                              gate_on)
        tf3, to3 = treset(tf2, to2)
        t_t = time.time() - t1
        counts = {k: [int(getattr(jst, k)), int(getattr(tst, k))]
                  for k in jst._fields}
        active_eq = bool((np.asarray(jf3.active)
                          == tf3.active.numpy()).all())
        params = {p: self.trainer_gate(getattr(jf3, p),
                                       self.t2n(getattr(tf3, p)))
                  for p in PARAMS}
        moments = {}
        for p in PARAMS:
            for name, a, b in (("mu", jo3.mu[p], to3.mu[p]),
                               ("nu", jo3.nu[p], to3.nu[p])):
                moments[f"{name}.{p}"] = float(np.abs(
                    np.asarray(a) - self.t2n(b)).max())
        # thresholds, in float64 from the shared state
        a = self.jnp_field(f)
        act = a["active"].astype(bool)
        den = a["grad_denom"].astype(np.float64)
        grads = np.where(den > 0, a["grad_accum"] / np.maximum(den, 1.0), 0)
        max_scale = np.exp(a["log_scales"].astype(np.float64)).max(1)
        opac = 1 / (1 + np.exp(-a["logit_opacity"].astype(np.float64)))
        dc = jt.cfg.densify
        sr = float(a["scene_radius"])
        near = {}
        for name, stat, thr in (
                ("grad_threshold", grads, dc.grad_threshold),
                ("min_opacity", opac, dc.min_opacity),
                ("clone_split_pivot", max_scale, dc.percent_dense * sr),
                ("prune_scale", max_scale, dc.prune_scale_frac * sr)):
            idx = np.flatnonzero(act & (np.abs(stat - thr)
                                        <= 1e-6 * abs(thr)))
            near[name] = {"threshold": thr, "count": int(idx.size),
                          "slots": idx[:50].tolist()}
        # the same densify on the port's own step-4 state (information)
        own = tdens(tstate_own.field, tstate_own.opt,
                    torch.from_numpy(noise), tt.cfg.densify, gate_on)[2]
        counts_equal = all(x == y for x, y in counts.values())
        out = {"gate": "clone / split / prune counts and the active set "
                       "equal; parameters at the Trainer gate",
               "counts": counts, "active_equal": active_eq,
               "params": params, "moments_max_abs": moments,
               "near_threshold_1e-6_rel": near,
               "port_own_state_counts": {k: int(getattr(own, k))
                                         for k in own._fields},
               "worst": max(v["worst"] for v in params.values()),
               "within_gate": counts_equal and active_eq
               and all(v["within_gate"] for v in params.values()),
               "seconds": {"jax": t_j, "port": t_t}}
        return out

    # ----------------------------------------------------------------- run
    def run(self, steps) -> dict:
        jax_state0 = self.jt.state
        res = {"hw": list(self.args.hw), "frames": FRAMES, "seed": SEED,
               "recipe_gaussians": 20000, "settings": CFG,
               "jax_impl": "pallas_interpret (CPU)",
               "port": "plain kernel versions (CPU)",
               "port_grad_sum": self.args.port_grad_sum,
               "threads": self.args.threads, "cuts": self.cuts,
               "jax_max_instances": int(self.jt.cfg.max_instances),
               "steps": {}}
        out = res["steps"]

        def done(name, r, t0):
            r.setdefault("seconds_total", time.time() - t0)
            out[name] = r
            self.log(f"step {name}: within_gate={r['within_gate']} "
                     f"worst={r.get('worst')}")
            (self.work / "witness_detail.json").write_text(
                json.dumps(res, indent=1) + "\n")

        if 1 in steps:
            t0 = time.time()
            done("1_init", self.step1(), t0)
        if 2 in steps:
            t0 = time.time()
            done("2_binning_init", self.step2(jax_state0, "init"), t0)
        if 3 in steps:
            t0 = time.time()
            done("3_render_fwd_bwd", self.step3(jax_state0), t0)
        js4 = ts4 = None
        if steps and max(steps) >= 4:
            # the caller's copy: the jitted mapping donates its input
            import jax
            import numpy as np
            snap = jax.tree.map(lambda x: np.array(x), jax_state0)
            t0 = time.time()
            r, js4, ts4 = self.step4(snap)
            if 4 in steps:
                done("4_mapping_chunk", r, t0)
                if 2 in steps:
                    t0 = time.time()
                    done("2_binning_after_mapping",
                         self.step2(js4, "after step 4"), t0)
        if 5 in steps:
            t0 = time.time()
            done("5_tracking_frame1", self.step5(js4), t0)
        if 6 in steps:
            t0 = time.time()
            done("6_densify", self.step6(js4, ts4), t0)
        res["all_within_gates"] = all(v["within_gate"] for v in out.values())
        res["seconds"] = time.time() - self.t_start
        return res


if __name__ == "__main__":
    raise SystemExit(main())
