"""Profiling and debugging hooks (port of ``freesurgs_tpu/utils/profiling.py``).

- ``trace(dir)``: a ``torch.profiler`` trace (CPU, and CUDA where there is
  a card) around any training region, written as ``<dir>/trace.json`` for
  chrome://tracing or Perfetto;
- ``StepTimer``: wall-clock per-step timing and rays/s (the reference's
  ``num_rays_per_step`` = H * W * 3), synchronizing the card only on a
  tensor it is handed;
- ``enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly``, the
  reference's own switch (fails loudly at the op that produced a NaN);
- for the measuring programs (``bench``, ``cli.bench_train_step``,
  ``cli.stage_timing``, ``cli.eval_ckpt``): ``resolve_device`` (the card
  unless the caller names the CPU; no fallback), ``device_label`` (the
  card's name and power limit, printed beside every time),
  ``synchronize``, ``device_time`` (kernel time and wall time of one
  traced call) and ``count_syncs`` (the host-device synchronizations of
  one call).

The JAX package's ``enable_compilation_cache`` has no counterpart: the
port runs eagerly and its kernels are cached by source hash in ``_build/``.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
import warnings

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging(enable: bool = True):
    torch.autograd.set_detect_anomaly(enable)


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
