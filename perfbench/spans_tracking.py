"""The program's spans of a progressive frame joined with a traced pass's
device trace: each kernel, idle gap and blocking call put down to the part
of the frame that issued it.

The rules are ``perfbench/spans.py``'s (a kernel belongs to the innermost
span open on its launching thread when its launch call started, else to
the innermost open on the main thread; an idle gap and a blocking call
where the runtime call before them belongs; a span that is no layer stands
for the nearest layer above it; what reaches none is ``other``), with the
layers of a progressive frame in place of the mapping iteration's:

  track         Trainer.track_frame's own lines
  track.init    the pose's init (RANSAC PnP, with its host reads)
  track.mask    the epipolar rigidity mask
  track.gn      the Gauss-Newton flow-PnP solve
  track.iter    tracking's Adam steps (their renders' ``project``, ``bin``
                and ``raster`` spans stand for it)
  map.iter      two-view mapping iterations (their layers stand for it)
  cache_render  a test frame's render into the caches

``metrics`` turns the join into the cell's per-layer metrics, each None
where the program opened no ``track`` span (a program without the
tracking spans).
"""

from __future__ import annotations

import bisect

from perfbench import spans as S
from perfbench import trace as trace_mod

TRACK = ("track", "track.init", "track.mask", "track.gn", "track.iter")
LAYERS = TRACK + ("map.iter", "cache_render")


class _Layers(S._Tree):
    """``spans._Tree`` with the progressive frame's layers."""

    def layer(self, s) -> str:
        if s is None:
            return "other"
        if s.id not in self.layer_of:
            up = s
            while up is not None and up.name not in LAYERS:
                up = self.by_id.get(up.parent)
            self.layer_of[s.id] = up.name if up is not None else "other"
        return self.layer_of[s.id]


def join(evs, spans, threads: dict, main_tid: int, window_s: float,
         program_kernels: set) -> dict:
    """Totals over the traced pass, by layer of ``LAYERS`` and ``other``:
    device ms of every kernel (``dev_ms``) and of those not built from the
    program's csrc/ (``torch_dev_ms``), device idle ms (``idle_ms``; the
    window's edges go to ``other``), blocking calls, launches and the main
    thread's self ms (``host_ms``); by span name, the count of spans and
    their summed wall ms (``span_ms``, children included)."""
    tree = _Layers(spans, threads, main_tid)
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
    parts = {k: {"dev_ms": 0.0, "torch_dev_ms": 0.0, "idle_ms": 0.0,
                 "syncs": 0, "launches": 0, "host_ms": 0.0}
             for k in LAYERS + ("other",)}
    busy, gaps = 0, []
    cur_s = cur_t = None
    for s, t, name, corr in dev:
        if not name.startswith(("Memcpy", "Memset")):
            c = by_corr.get(corr)
            p = parts[tree.layer(tree.at(c[3], c[0]) if c else None)]
            p["launches"] += 1
            p["dev_ms"] += (t - s) * 1e-6
            if trace_mod.base_name(name) not in program_kernels:
                p["torch_dev_ms"] += (t - s) * 1e-6
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
        parts[tree.layer(tree.at(c[3], c[0]) if c else None)]["idle_ms"] += \
            (g1 - g0) * 1e-6
    idle_ms = window_s * 1e3 - busy * 1e-6
    parts["other"]["idle_ms"] += idle_ms - sum(
        p["idle_ms"] for p in parts.values())
    for s, _, name, tid in calls:
        if name in trace_mod.SYNC_CALLS:
            parts[tree.layer(tree.at(tid, s))]["syncs"] += 1
    main = [s for s in spans if s.tid == main_tid]
    child_ns: dict[int, int] = {}
    for s in main:
        child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    for s in main:
        parts[tree.layer(s)]["host_ms"] += (
            s.end_ns - s.start_ns - child_ns.get(s.id, 0)) * 1e-6
    count: dict[str, int] = {}
    span_ms: dict[str, float] = {}
    for s in spans:
        count[s.name] = count.get(s.name, 0) + 1
        span_ms[s.name] = span_ms.get(s.name, 0.0) + \
            (s.end_ns - s.start_ns) * 1e-6
    return {"layers": parts, "spans": count, "span_ms": span_ms,
            "idle_ms": idle_ms, "calls": len(calls),
            "unmatched_calls": sum(c[3] is None for c in calls)}


def metrics(j: dict | None) -> dict:
    """The join's per-layer metrics of the cell, each per tracked frame (a
    ``track`` span): none where there is no ``track`` span, and the device
    metrics only where the trace holds kernels."""
    n = (j or {}).get("spans", {}).get("track", 0)
    if not n:
        return {}
    lay = j["layers"]
    out = {"pnp_ms_per_frame.nonrigid":
           j["span_ms"].get("track.init", 0.0) / n}
    if not sum(p["launches"] for p in lay.values()):
        return out
    return {
        **out,
        "rigid_mask_dev_ms_per_frame.nonrigid":
            lay["track.mask"]["dev_ms"] / n,
        "track_dev_ms_per_frame.nonrigid":
            sum(lay[k]["dev_ms"] for k in TRACK) / n,
        "track_idle_ms_per_frame.nonrigid":
            sum(lay[k]["idle_ms"] for k in TRACK) / n}
