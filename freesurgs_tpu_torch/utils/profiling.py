"""Profiling and debugging hooks (port of ``freesurgs_tpu/utils/profiling.py``).

- ``trace(dir)``: a ``torch.profiler`` trace (CPU, and CUDA where there is
  a card) around any training region, written as ``<dir>/trace.json`` for
  chrome://tracing or Perfetto;
- ``StepTimer``: wall-clock per-step timing and rays/s (the reference's
  ``num_rays_per_step`` = H * W * 3), synchronizing the card only on a
  tensor it is handed;
- ``enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly``, the
  reference's own switch (fails loudly at the op that produced a NaN).

The JAX package's ``enable_compilation_cache`` has no counterpart: the
port runs eagerly and its kernels are cached by source hash in ``_build/``.
"""

from __future__ import annotations

import contextlib
import os
import time

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
