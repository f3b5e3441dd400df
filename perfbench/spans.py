"""The program's spans (``freesurgs_tpu_torch/utils/profiling.py span``)
joined with a traced window's device trace: each kernel, each idle gap and
each blocking call put down to the layer of the mapping iteration that
issued it.

  python3 -m perfbench.spans --workload <cell> --seed <n> [--spans 0|1]

runs the cell's set-up and a traced window (``trace_iterations`` in whole
chunks) as the stage driver's ``--trace 1`` run does, with the program's
span recorder on from just before the profiler starts to just after it
stops (``--spans 0``: left off), and prints one JSON line: the readings of
the benchmark's per-layer metrics that need no work counts, the join
(``join``) under the names of the metrics it would feed, its closures
against ``torch_ops_device_ms_per_it.global`` and ``device_idle.global``,
the binner's runs against the window's draws, and the cost of a span.

The spans and the trace's events share one clock (``time.time_ns()``'s,
which torch.profiler's events carry). The join's rules:

- a kernel belongs to the innermost span open, on the thread that launched
  it, when its launch call started (the call found by correlation id); with
  none open on that thread, to the innermost open on the main thread (the
  one that turned the recorder on);
- an idle gap (as ``trace.reduce`` finds them) belongs where the runtime
  call before it belongs by the same rule, and so does a blocking call;
- a span that is no layer (``k2``, ``grad_sum``) stands for the nearest
  layer above it; what reaches no layer (``map.iter``'s own lines,
  ``chunk``'s, what runs outside any span, the window's edges) is
  ``other``, so that the parts sum to the whole.
"""

from __future__ import annotations

import argparse
import bisect
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np

from perfbench import run
from perfbench import trace as trace_mod

LAYERS = ("project", "bin", "raster", "loss", "backward", "update")


def events(prof):
    """(name, on_device, start_ns, end_ns, thread ids, correlation id) of
    every event of a finished ``torch.profiler`` trace; a host event's
    thread ids are those kineto records for it (resource, then thread)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA, s,
               s + e.duration_ns(), (e.device_resource_id(),
                                     e.start_thread_id()), e.correlation_id())


class _Tree:
    """The spans by thread, for the innermost open span at a time."""

    def __init__(self, spans, threads: dict, main_tid: int):
        self.main = main_tid
        self.by_id = {s.id: s for s in spans}
        self.by_tid: dict[int, list] = {}
        for s in sorted(spans, key=lambda s: (s.start_ns, s.id)):
            self.by_tid.setdefault(s.tid, []).append(s)
        self.starts = {t: [s.start_ns for s in v]
                       for t, v in self.by_tid.items()}
        # kineto names a CPU op's thread by its OS id, a CUDA runtime
        # call's by the low 32 bits of its pthread id, signed
        # (libkineto::threadId())
        self.alias = {}
        for native, ident in threads.items():
            low = ident & 0xFFFFFFFF
            self.alias[native] = self.alias[low - (low >> 31 << 32)] = native
        self.layer_of: dict[int, str] = {}

    def thread(self, ids):
        for t in ids:
            if t in self.alias:
                return self.alias[t]
        return None

    def innermost(self, tid, t):
        lst = self.by_tid.get(tid)
        if not lst:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        s = lst[i] if i >= 0 else None
        # spans on one thread nest: up the parents until one is still open
        while s is not None and s.tid == tid:
            if s.end_ns > t:
                return s
            s = self.by_id.get(s.parent)
        return None

    def at(self, tid, t):
        s = self.innermost(tid, t) if tid is not None else None
        if s is None and tid != self.main:
            s = self.innermost(self.main, t)
        return s

    def layer(self, s) -> str:
        if s is None:
            return "other"
        if s.id not in self.layer_of:
            up = s
            while up is not None and up.name not in LAYERS:
                up = self.by_id.get(up.parent)
            self.layer_of[s.id] = up.name if up is not None else "other"
        return self.layer_of[s.id]


def join(evs, spans, threads: dict, main_tid: int, iterations: int,
         window_s: float, program_kernels: set) -> dict:
    """Per layer of ``LAYERS`` and ``other``, per iteration: device ms of
    the kernels not built from the program's csrc/ (``dev_ms``), device
    idle ms (``idle_ms``, the gaps of ``trace.reduce`` plus, under
    ``other``, the window's time before the first and after the last
    device operation), blocking calls (``syncs``), kernel launches
    (``launches``) and the main thread's self time in the layer's spans
    (``host_ms``). Also the totals the parts sum to, and the launch calls
    whose thread matched no span thread (``unmatched_calls``)."""
    tree = _Tree(spans, threads, main_tid)
    dev, calls, by_corr = [], [], {}
    for name, on_dev, s, t, tids, corr in evs:
        if on_dev:
            dev.append((s, t, name, corr))
        elif name.startswith("cu"):
            c = (s, t, name, tree.thread(tids))
            calls.append(c)
            by_corr[corr] = c
    dev.sort()
    calls.sort()
    parts = {k: {"dev_ms": 0.0, "idle_ms": 0.0, "syncs": 0, "launches": 0,
                 "host_ms": 0.0} for k in LAYERS + ("other",)}
    unmatched = sum(c[3] is None for c in calls)
    busy = 0
    cur_s = cur_t = None
    gaps = []
    for s, t, name, corr in dev:
        if not name.startswith(("Memcpy", "Memset")):
            c = by_corr.get(corr)
            p = parts[tree.layer(tree.at(c[3], c[0]) if c else None)]
            p["launches"] += 1
            if trace_mod.base_name(name) not in program_kernels:
                p["dev_ms"] += (t - s) * 1e-6
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    starts = [c[0] for c in calls]
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        c = calls[i] if i >= 0 else None
        p = parts[tree.layer(tree.at(c[3], c[0]) if c else None)]
        p["idle_ms"] += (g1 - g0) * 1e-6
    idle_ms = window_s * 1e3 - busy * 1e-6
    parts["other"]["idle_ms"] += idle_ms - sum(
        p["idle_ms"] for p in parts.values())
    for s, _, name, tid in calls:
        if name in trace_mod.SYNC_CALLS:
            parts[tree.layer(tree.at(tid, s))]["syncs"] += 1
    # the main thread's self time: a span's length less its children's
    main = [s for s in spans if s.tid == main_tid]
    child_ns: dict[int, int] = {}
    for s in main:
        child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    for s in main:
        parts[tree.layer(s)]["host_ms"] += (
            s.end_ns - s.start_ns - child_ns.get(s.id, 0)) * 1e-6
    n = max(iterations, 1)
    per_it = {k: {q: v / n for q, v in p.items()} for k, p in parts.items()}
    return {"layers": per_it,
            "torch_ops_ms_per_it": sum(p["dev_ms"] for p in parts.values())
            / n,
            "idle_ms_per_it": idle_ms / n, "unmatched_calls": unmatched,
            "calls": len(calls)}


def metrics(j: dict, bins: dict) -> dict:
    """The join (None without spans) and the window's counter deltas under
    the names of the per-layer metrics they would feed."""
    out = {}
    for s in LAYERS if j else ():
        out[f"{s}_dev_ms_per_it.global"] = j["layers"][s]["dev_ms"]
        out[f"{s}_idle_ms_per_it.global"] = j["layers"][s]["idle_ms"]
    if bins["renders"]:
        out["rebins_per_render.global"] = \
            bins["build_tile_bins"] / bins["renders"]
    return out


def implied_rebins(draws, i_train, chunk: int, n_chunks: int,
                   rebin_every: int) -> tuple[int, int]:
    """(binner runs, renders) that the window's draws imply: each chunk's
    frames as ``Trainer.global_run`` draws them (sorted when the layout is
    carried), each rebinned where ``mapping_chunk`` rebins (no densify or
    reset falls in the window)."""
    n = 0
    for _ in range(n_chunks):
        ts = draws.choice(np.asarray(i_train, np.int64), size=chunk)
        if rebin_every > 1:
            ts = np.sort(ts)
        prev = None
        for k, t in enumerate(ts.tolist()):
            n += rebin_every <= 1 or k == 0 or t != prev or \
                k % rebin_every == 0
            prev = t
    return n, chunk * n_chunks


def span_cost_us(n: int = 20_000) -> dict:
    """Host microseconds of one empty span, recorder off and on, less the
    loop's own, and of one read of the spans' clock."""
    import gc
    from freesurgs_tpu_torch.utils import profiling as P
    gc.collect()

    def loop(on):
        if on:
            P.SPANS.start()
        t0 = time.perf_counter()
        for _ in range(n):
            with P.span("x"):
                pass
        t = time.perf_counter() - t0
        P.SPANS.stop()
        return t

    t0 = time.perf_counter()
    for _ in range(n):
        pass
    empty = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        time.time_ns()
    clock = time.perf_counter() - t0
    return {"off": (loop(False) - empty) / n * 1e6,
            "on": (loop(True) - empty) / n * 1e6,
            "clock": (clock - empty) / n * 1e6}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    return ap.parse_args(argv)


def main(argv=None, *, device: str = "cuda", root: Path = run.ROOT,
         here: Path = run.HERE) -> int:
    args = parse(argv)
    bench, cell, spec, traffic, _ = run.load_cell(args.workload, root, here)
    if device == "cuda" and cell["chips"] == 1:
        run.pin()
    cost = span_cost_us()
    import torch
    from freesurgs_tpu_torch.ops import raster_cuda as rc
    from freesurgs_tpu_torch.utils import profiling as P
    cuda = device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    stage = run.load_stage(traffic, here)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    trainer, inputs = stage.prepare(spec, traffic, args.seed, device, log)
    chunk, start = spec["global_chunk"], traffic["start_iteration"]
    stage.window(trainer, chunk, start,
                 lambda n: n < traffic["warmup_chunks"])
    if cuda:
        torch.cuda.synchronize()
    draws = copy.deepcopy(trainer._global_rng)
    n_trace = -(-traffic["trace_iterations"] // chunk)
    bins0 = dict(rc.BINS)
    prof = trace_mod.profile(cuda)
    if args.spans:
        P.SPANS.start()
    prof.__enter__()
    t0 = time.perf_counter()
    n_chunks = stage.window(trainer, chunk, start, lambda n: n < n_trace)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof.__exit__(None, None, None)
    spans = P.SPANS.stop()
    bins = {k: v - bins0[k] for k, v in rc.BINS.items()}
    iters = n_chunks * chunk
    own = run.program_kernels(root)
    red = trace_mod.reduce(prof, iters)
    j = join(events(prof), spans, P.SPANS.threads, P.SPANS.main_tid, iters,
             t1 - t0, own) if spans else None
    del prof
    ctx = {"trace": red, "work": None, "window_s": t1 - t0,
           "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
           "program_kernels": own}
    readings = {}
    for name in ("device_idle.global", "torch_ops_device_ms_per_it.global",
                 "host_syncs_per_it.global", "launches_per_it.global"):
        v = run._load(here / "metrics" / f"{name}.py",
                      f"perfbench_metric_{name}").read(ctx)
        if v is not None:
            readings[name] = v
    implied = implied_rebins(draws, inputs["seq"].i_train, chunk, n_chunks,
                             trainer.cfg.rebin_every)
    line = {"workload": cell["name"], "seed": args.seed,
            "spans": bool(args.spans), "n_spans": len(spans),
            "iterations": iters, "window_s": t1 - t0,
            "readings": readings, "metrics": metrics(j, bins), "join": j,
            "closure": j and {
                "torch_ops_ms_per_it": [j["torch_ops_ms_per_it"],
                                        readings.get(
                                            "torch_ops_device_ms_per_it"
                                            ".global")],
                "idle_ms_per_it": [
                    j["idle_ms_per_it"],
                    readings.get("device_idle.global", 0) / 100
                    * (t1 - t0) * 1e3 / iters]},
            "bins": bins, "implied_bins_renders": list(implied),
            "span_cost_us": cost,
            "card": run.card_label() if cuda else "cpu"}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
