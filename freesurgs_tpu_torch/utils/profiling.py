"""Profiling hooks (port of ``freesurgs_tpu/utils/profiling.py``).

- ``span(name)`` and ``SPANS``: spans at the layer boundaries of a mapping
  iteration (see "Spans" below), recorded in memory while ``SPANS`` is on;
- ``trace(dir)``: a ``torch.profiler`` trace (CPU, and CUDA where there is
  a card) around any training region, written as ``<dir>/trace.json`` for
  chrome://tracing or Perfetto, with the spans recorded meanwhile merged
  in on the profiler's clock;
- ``StepTimer``: wall-clock per-step timing and rays/s (the reference's
  ``num_rays_per_step`` = H * W * 3), synchronizing the card only on a
  tensor it is handed;
- for the measuring programs (``bench``, ``cli.bench_train_step``,
  ``cli.stage_timing``, ``cli.eval_ckpt``): ``resolve_device`` (the card
  unless the caller names the CPU; no fallback), ``device_label`` (the
  card's name and power limit, printed beside every time),
  ``synchronize``, ``device_time`` (kernel time and wall time of one
  traced call) and ``count_syncs`` (the host-device synchronizations of
  one call).

The JAX package's ``enable_compilation_cache`` has no counterpart: the
port runs eagerly and its kernels are cached by source hash in ``_build/``.
Nor has its ``enable_nan_debugging``: ``cli.train --run_debug_nans`` runs
under ``torch.autograd.set_detect_anomaly`` itself.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import threading
import time
import warnings
from typing import NamedTuple

import torch

# ------------------------------------------------------------------ spans
#
# The spans of one global mapping iteration (``train/steps.py
# mapping_chunk``) and the layers they cover:
#
#   chunk       train/loop.py global_run, one chunk: draws, the mapping_chunk
#               call, capacity growth, the history row's host reads
#   map.iter    one iteration; its ``request`` is the global iteration it
#               maps (the counter after the step), shared by its children
#   project     ops/render.py _raster_inputs: world->camera, projection,
#               SH->RGB (ops/project_cuda.py: one kernel launch; its
#               backward kernel runs under ``backward``)
#   raster      ops/render.py render after the projection: the binning
#               (``bin``, inside it), the records, K1, the background
#   bin         ops/raster_cuda.py rasterize: pruning, snug rects and the
#               binner, or the carried layout's overflow check
#   loss        mapping_chunk's losses: L1 + SSIM, Pearson, local Pearson
#   backward    the torch.autograd.grad call; autograd's device thread opens
#               ``k2`` (K2) and ``grad_sum`` (the per-Gaussian reduction)
#               under it, from ops/raster_cuda.py Composite.backward
#   update      the rest: NaN guard, densify statistics, Adam, densify and
#               reset checks, prediction caches, the chunk's maxima
#
# Off (the default), ``span`` costs one flag test and returns a shared
# no-op context: no clock read, no allocation. On, a span reads
# ``time.time_ns()`` twice, the clock torch.profiler's events carry, so the
# two join without a conversion. A span never launches, never
# synchronizes and never reads a device value.


class Span(NamedTuple):
    """A closed span. ``tid``: the OS thread id (``threading.
    get_native_id``); ``parent``: the id of the span it opened under, 0 for
    none; ``request``: the global mapping iteration it belongs to, None
    outside one."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    tid: int
    parent: int
    request: int | None


class SpanRecorder:
    """Records spans between ``start`` and ``stop``, in memory. A span
    opened on a thread with none open of its own (autograd's device thread
    in a backward) opens under the innermost span open on the thread that
    called ``start``."""

    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        self.main_tid = 0
        # by threading.get_ident(), which needs no system call: each
        # thread's open (id, request) pairs and its OS id
        self._open: dict[int, list] = {}
        self._tid: dict[int, int] = {}
        self._main = 0
        self._ids = itertools.count(1)

    @property
    def threads(self) -> dict[int, int]:
        """{OS id: ``threading.get_ident()``} of the threads that opened a
        span since ``start``."""
        return {tid: ident for ident, tid in self._tid.items()}

    def start(self) -> None:
        self.spans, self._open, self._tid = [], {}, {}
        self._ids = itertools.count(1)
        self.main_tid = threading.get_native_id()
        self._main = threading.get_ident()
        self.on = True

    def stop(self) -> list[Span]:
        """Turn recording off and hand out the spans closed since
        ``start``."""
        self.on = False
        spans, self.spans = self.spans, []
        return spans


class _Open:
    __slots__ = ("rec", "name", "request", "frame")

    def __init__(self, rec: SpanRecorder, name: str, request):
        self.rec, self.name, self.request = rec, name, request

    def __enter__(self):
        rec = self.rec
        ident = threading.get_ident()
        stack = rec._open.get(ident)
        if stack is None:
            stack = rec._open[ident] = []
            rec._tid[ident] = threading.get_native_id()
        up = stack or rec._open.get(rec._main) or [(0, None)]
        parent, request = up[-1]
        if self.request is not None:
            request = self.request
        sid = next(rec._ids)
        stack.append((sid, request))
        self.frame = (sid, ident, parent, request, time.time_ns())
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        sid, ident, parent, request, start = self.frame
        rec = self.rec
        stack = rec._open.get(ident)
        if stack:
            stack.pop()
        rec.spans.append(Span(sid, self.name, start, end,
                              rec._tid.get(ident, 0), parent, request))
        return False


SPANS = SpanRecorder()
_OFF = contextlib.nullcontext()


def span(name: str, request: int | None = None):
    """A context that records ``name`` as a span while ``SPANS`` is on;
    ``request`` (default: the parent's) names the mapping iteration."""
    if not SPANS.on:
        return _OFF
    return _Open(SPANS, name, request)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region (CPU, and CUDA where there is a card) with the
    span recorder on, and write ``<dir>/trace.json``: the profiler's chrome
    trace with each span added as a complete event ("cat": "span") on its
    thread's row, its id, parent and request under "args". Yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    SPANS.start()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        spans = SPANS.stop()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # the chrome trace's "ts" is microseconds after baseTimeNanoseconds
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"] += [
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "request": s.request}}
        for s in spans]
    with open(path, "w") as f:
        json.dump(doc, f)


class StepTimer:
    """Per-step wall timing + rays/s (reference ``num_rays_per_step`` =
    H * W * 3, ``train.py:99``)."""

    def __init__(self, height: int, width: int):
        self.rays_per_step = height * width * 3
        self._t = None
        self.last_dt = float("nan")

    def start(self):
        self._t = time.time()

    def stop(self, sync_on=None) -> float:
        """Seconds since ``start``; with ``sync_on`` a CUDA tensor, after
        synchronizing its device (the work queued so far has finished)."""
        if torch.is_tensor(sync_on) and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        self.last_dt = time.time() - self._t
        return self.last_dt

    @property
    def rays_per_sec(self) -> float:
        return self.rays_per_step / self.last_dt


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the default of every
    entry point) or ``cpu``. A CUDA device without a card raises: nothing
    falls back to the CPU by itself."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "--device cpu to run on the CPU")
    return dev


def device_label(dev) -> str:
    """What a measured time is printed beside: the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or ``"cpu"``."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    res = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def synchronize(dev) -> None:
    """Wait for the work queued on ``dev`` (a no-op on the CPU)."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_time(fn, dev) -> tuple[float, float] | None:
    """(kernel seconds on the card, wall seconds) of one call of ``fn``,
    traced by ``torch.profiler`` (the trace's cost lands in the wall time,
    so keep it out of a timed window). None on the CPU, or when the trace
    shows no device time."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's event repeats its kernels' time
    dev_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA)
    return (dev_us / 1e6, wall) if dev_us > 0 else None


def count_syncs(fn) -> int:
    """Host-device synchronizations while ``fn`` runs on the card (host
    reads and blocking host-to-device copies), counted by torch's sync
    debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)
