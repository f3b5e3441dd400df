"""The join of the program's spans with the device trace
(``perfbench/spans.py``) on the card: the span recorder and
torch.profiler's CUDA activity trace share one clock and one naming of
threads, so that each launch call falls in the span that made it."""

import json
import time

import pytest
import torch

from perfbench import spans as S
from perfbench import trace as trace_mod

N_K1 = 5


def _launch(name: str) -> bool:
    return "LaunchKernel" in name


@pytest.mark.card
def test_launch_calls_fall_in_their_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from freesurgs_tpu_torch.bench import bench_scene
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.ops.raster_ablate import records_for
    from freesurgs_tpu_torch.ops.render import render
    from freesurgs_tpu_torch.utils import profiling as P

    rc.build_kernels()
    dev = torch.device("cuda", 0)
    cam, params = bench_scene(dev)
    cfg, feat, rect, bins, _ = records_for(cam, params)

    def k1():
        return rc.composite_fwd(feat, rect, bins.tile_start, bins.tile_count,
                                cfg.grid_x, cfg.grid_y)

    leaves = [p.detach().requires_grad_(True) for p in params]

    def step():
        out = render(*leaves, torch.eye(4, device=dev), cam, sh_degree=3)
        with P.span("backward"):
            torch.autograd.grad(out["render"].sum(), leaves)

    k1()
    step()
    torch.cuda.synchronize()
    prof = trace_mod.profile(True)
    P.SPANS.start()
    prof.__enter__()
    t_a = time.time_ns()
    torch.cuda.synchronize()
    t_b = time.time_ns()
    with P.span("k1"):
        for _ in range(N_K1):
            k1()
    step()
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    spans = P.SPANS.stop()
    evs = list(S.events(prof))

    tree = S._Tree(spans, P.SPANS.threads, P.SPANS.main_tid)
    names = {c: n for n, on_dev, _, _, _, c in evs if on_dev}
    calls = [(s, t, n, tids, tree.thread(tids), names.get(c))
             for n, on_dev, s, t, tids, c in evs
             if not on_dev and n.startswith("cu")]
    by = {s.name: s for s in spans}
    k1_span, bwd = by["k1"], by["backward"]
    k2s = [s for s in spans if s.name == "k2"]

    def inside(c, s):
        return s.start_ns <= c[0] and c[1] <= s.end_ns

    in_k1 = [c for c in calls if _launch(c[2]) and c[4] == k1_span.tid
             and inside(c, k1_span)]
    k1_calls = [c for c in calls if c[5] and "composite_fwd_kernel" in c[5]]
    k2_calls = [c for c in calls if c[5] and "composite_bwd_kernel" in c[5]]
    sync = [c for c in calls if c[2] in ("cudaDeviceSynchronize",
                                         "cuCtxSynchronize")
            and t_a - 10**6 <= c[0] <= t_b + 10**6]
    margins = [min(c[0] - k1_span.start_ns, k1_span.end_ns - c[1])
               for c in in_k1]
    margins += [min(c[0] - s.start_ns, s.end_ns - c[1])
                for c in k2_calls for s in k2s if inside(c, s)]
    margins += [min(c[0] - t_a, t_b - c[1]) for c in sync]
    report = {"k1_launch_calls_in_span": len(in_k1),
              "k1_launch_calls": len(k1_calls),
              "k2_launch_calls": len(k2_calls),
              "span_threads": P.SPANS.threads, "main": P.SPANS.main_tid,
              "k1_call_tids": sorted({c[3] for c in k1_calls}),
              "k2_call_tids": sorted({c[3] for c in k2_calls}),
              "call_tids": sorted({c[3] for c in calls}),
              "unmatched_calls": sum(c[4] is None for c in calls),
              "calls": len(calls),
              "least_margin_us": min(margins) / 1e3 if margins else None,
              "largest_clock_offset_us": max([0] + [-m for m in margins])
              / 1e3}
    print(json.dumps({"spans_card": report}), flush=True)
    # K1's span holds its N launch calls and no other launch of its thread
    assert len(in_k1) == N_K1
    assert all(c[5] and "composite_fwd_kernel" in c[5] for c in in_k1)
    assert len(k1_calls) == N_K1 + 1           # and the render's own
    # K2 launches from autograd's device thread, inside a k2 span opened
    # there under the main thread's backward span
    assert len(k2_calls) == 1 and len(k2s) == 1
    (c2,), (k2,) = k2_calls, k2s
    assert c2[4] == k2.tid != P.SPANS.main_tid and inside(c2, k2)
    assert k2.parent == bwd.id
    assert sync and all(t_a <= c[0] and c[1] <= t_b for c in sync)
