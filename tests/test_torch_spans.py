"""The span recorder (``utils/profiling.py span``) in the port's mapping
iteration, the binner / render counters (``ops/raster_cuda.BINS``), and the
benchmark's join of spans with a device trace (``perfbench/spans.py``).

- spans on or off, a global-stage run carrying its layout (``rebin_every``
  4) ends in the same state, bit for bit;
- every iteration's ``map.iter`` holds one span of each layer, each inside
  its parent's interval and sharing its request (the global iteration);
- the counters follow the rebin schedule of the window's draws;
- a span and torch.profiler's events share one clock;
- the join puts synthetic kernels, gaps and blocking calls of two threads
  down to the layers, and the parts sum to the totals.
"""

import copy
import threading

import numpy as np
import pytest
import torch

from freesurgs_tpu_torch.data.synthetic import SceneSequence, make_scene
from freesurgs_tpu_torch.ops import raster_cuda as rc
from freesurgs_tpu_torch.train import loop
from freesurgs_tpu_torch.train.steps import TrainConfig
from freesurgs_tpu_torch.utils import profiling as P
from perfbench import spans as S
from perfbench.stages import global_run as stage

H, W = 32, 48
CHUNK, ITERS = 6, 12
UNDER_ITER = {"project": 1, "raster": 1, "bin": 1, "loss": 1,
              "backward": 1, "k2": 1, "grad_sum": 1, "update": 1}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    P.SPANS.stop()


def _trainer():
    sc = make_scene(num_frames=4, n_gaussians=80, height=H, width=W, seed=2,
                    device="cpu")
    return loop.Trainer(SceneSequence(sc), TrainConfig(rebin_every=4),
                        sh_degree_max=0, capacity=4096, global_chunk=CHUNK,
                        device="cpu", validation_every=0,
                        log_fn=lambda *a: None)


def _state(tr) -> dict:
    st = tr.state
    return {**{f"p.{k}": v for k, v in st.field.param_dict().items()},
            **{f"mu.{k}": v for k, v in st.opt.mu.items()},
            **{f"nu.{k}": v for k, v in st.opt.nu.items()},
            "active": st.field.active, "depths": st.pred_depths,
            "colors": st.pred_colors}


def test_spans_leave_the_state_bitwise():
    states = []
    for on in (False, True):
        tr = _trainer()
        if on:
            P.SPANS.start()
        tr.global_run(ITERS)
        spans = P.SPANS.stop()
        assert bool(spans) == on
        states.append((_state(tr), tr.history))
    (a, ha), (b, hb) = states
    assert ha == hb
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_each_iteration_holds_every_layer():
    tr = _trainer()
    P.SPANS.start()
    tr.global_run(ITERS)
    spans = P.SPANS.stop()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    chunks = [s for s in spans if s.name == "chunk"]
    iters = sorted((s for s in spans if s.name == "map.iter"),
                   key=lambda s: s.start_ns)
    assert len(chunks) == ITERS // CHUNK
    assert all(c.parent == 0 and c.request is None for c in chunks)
    assert [s.request for s in iters] == list(range(1, ITERS + 1))
    assert {by_id[s.parent].name for s in iters} == {"chunk"}
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.tid == P.SPANS.main_tid
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s
    parent_of = {"project": "map.iter", "raster": "map.iter",
                 "bin": "raster", "loss": "map.iter",
                 "backward": "map.iter", "k2": "backward",
                 "grad_sum": "backward", "update": "map.iter"}
    for it in iters:
        under = []
        todo = [it.id]
        while todo:
            pid = todo.pop()
            kids = [s for s in spans if s.parent == pid]
            under += kids
            todo += [s.id for s in kids]
        assert {n: sum(s.name == n for s in under) for n in UNDER_ITER} \
            == UNDER_ITER
        assert len(under) == len(UNDER_ITER)
        for s in under:
            assert s.request == it.request
            assert by_id[s.parent].name == parent_of[s.name]


def test_counters_follow_the_rebin_schedule():
    tr = _trainer()
    draws = copy.deepcopy(tr._global_rng)
    again = copy.deepcopy(draws)
    rc.reset_bins()
    tr.global_run(ITERS)
    want = 0
    for _ in range(ITERS // CHUNK):
        ts = np.sort(draws.choice(np.asarray(tr.seq.i_train, np.int64),
                                  size=CHUNK)).tolist()
        want += sum(stage._rebin_schedule(ts, 4))
    assert rc.BINS == {"build_tile_bins": want, "renders": ITERS}
    assert 0 < want < ITERS
    assert S.implied_rebins(again, tr.seq.i_train, CHUNK, ITERS // CHUNK,
                            4) == (want, ITERS)


def test_span_shares_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(96, 96)
    P.SPANS.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("mm"):
            torch.mm(a, a)
    (sp,) = P.SPANS.stop()
    ev = [e for e in S.events(prof) if e[0] == "aten::mm"]
    assert len(ev) == 1
    _, on_dev, s, t, tids, _ = ev[0]
    assert not on_dev
    assert sp.start_ns <= s <= t <= sp.end_ns
    assert sp.tid in tids


def test_span_off_records_nothing():
    assert not P.SPANS.on
    a, b = P.span("a"), P.span("b", request=3)
    assert a is b
    with a:
        torch.ones(3).sum()
    tr = _trainer()
    tr.global_run(CHUNK)
    assert P.SPANS.spans == [] and P.SPANS.stop() == []


def test_span_on_another_thread_opens_under_the_main_threads():
    """autograd's device thread runs a backward while the main thread waits
    inside its ``backward`` span: a span it opens (``k2``) is that one's
    child, of the same request."""
    P.SPANS.start()
    with P.span("map.iter", request=7):
        with P.span("backward"):
            th = threading.Thread(target=lambda: P.span("k2").__enter__()
                                  .__exit__(None, None, None))
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
    spans = {s.name: s for s in P.SPANS.stop()}
    assert spans["k2"].parent == spans["backward"].id
    assert spans["k2"].request == spans["backward"].request == 7
    assert spans["k2"].tid != spans["backward"].tid
    assert set(P.SPANS.threads) == {spans["k2"].tid, spans["backward"].tid}


def _span(i, name, s, t, tid, parent, request=None):
    return P.Span(i, name, s, t, tid, parent, request)


def test_join_puts_kernels_gaps_and_syncs_down_to_layers():
    main, grad = 100, 200
    threads = {main: 1100, grad: 1200}
    spans = [_span(1, "chunk", 0, 1000, main, 0),
             _span(2, "map.iter", 10, 900, main, 1, 1),
             _span(3, "project", 20, 100, main, 2, 1),
             _span(4, "raster", 100, 300, main, 2, 1),
             _span(5, "bin", 110, 200, main, 4, 1),
             _span(6, "loss", 300, 400, main, 2, 1),
             _span(7, "backward", 400, 700, main, 2, 1),
             _span(8, "k2", 450, 500, grad, 7, 1),
             _span(9, "update", 700, 890, main, 2, 1)]
    ew = "void at::native::vectorized_elementwise_kernel<4, F>(int, F)"

    def launch(s, tid, corr, name, d0, d1):
        return [("cudaLaunchKernel", False, s, s + 2, (tid, 0), corr),
                (name, True, d0, d1, (0, 0), corr)]

    evs = (launch(5, 999, 10, "x", 7, 8)                 # unknown thread
           + launch(30, 1100, 1, ew, 40, 50)             # by its pthread id
           + launch(150, main, 2, "indexFuncLargeIndex", 160, 180)
           + [("cudaStreamSynchronize", False, 160, 165, (main, 0), 3)]
           + launch(250, main, 4, "composite_fwd_kernel", 260, 300)
           + launch(350, main, 5, "gemm", 355, 375)
           + launch(460, grad, 6, "composite_bwd_kernel", 465, 495)
           + launch(600, grad, 7, ew, 605, 615)          # outside k2
           + launch(750, main, 8, "adam", 760, 800)
           + launch(950, main, 9, "fill", 955, 960))     # chunk: other
    own = {"composite_fwd_kernel", "composite_bwd_kernel"}
    j = S.join(evs, spans, threads, main, 1, 1000e-9, own)
    L = j["layers"]
    ns = 1e-6
    want_dev = {"project": 10, "bin": 20, "raster": 0, "loss": 20,
                "backward": 10, "update": 40, "other": 6}
    want_idle = {"project": 110, "bin": 80, "raster": 55, "loss": 90,
                 "backward": 110 + 145, "update": 155,
                 "other": 32 + (1000 - 176 - 777)}
    want_launches = {"project": 1, "bin": 1, "raster": 1, "loss": 1,
                     "backward": 2, "update": 1, "other": 2}
    for k in want_dev:
        assert L[k]["dev_ms"] == pytest.approx(want_dev[k] * ns), k
        assert L[k]["idle_ms"] == pytest.approx(want_idle[k] * ns), k
        assert L[k]["launches"] == want_launches[k], k
        assert L[k]["syncs"] == (k == "bin"), k
    assert j["torch_ops_ms_per_it"] == pytest.approx(106 * ns)
    assert sum(p["dev_ms"] for p in L.values()) == \
        pytest.approx(j["torch_ops_ms_per_it"])
    assert j["idle_ms_per_it"] == pytest.approx((1000 - 176) * ns)
    assert sum(p["idle_ms"] for p in L.values()) == \
        pytest.approx(j["idle_ms_per_it"])
    assert j["unmatched_calls"] == 1
    # host self time: the main thread's spans less their children
    assert L["raster"]["host_ms"] == pytest.approx(110 * ns)
    assert L["backward"]["host_ms"] == pytest.approx(300 * ns)
    assert L["other"]["host_ms"] == pytest.approx((110 + 20) * ns)
    m = S.metrics(j, {"build_tile_bins": 3, "renders": 8})
    assert m["bin_dev_ms_per_it.global"] == L["bin"]["dev_ms"]
    assert m["backward_idle_ms_per_it.global"] == L["backward"]["idle_ms"]
    assert m["rebins_per_render.global"] == 3 / 8
    assert len(m) == 13
