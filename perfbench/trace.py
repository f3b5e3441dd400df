"""The traced window: a ``torch.profiler`` trace of the device (CUPTI
activity: kernels, copies and the CUDA runtime calls that issue them),
reduced to what the per-layer readers need.

``reduce`` returns:
  busy_s              the seconds in which any device operation ran (the
                      union of their intervals);
  kernels             {name: [launches, seconds]}, by the kernel's function
                      name (demangled, without namespace or arguments);
  runtime             {call: count} of the CUDA runtime / driver calls;
  syncs               blocking calls (stream, device and event
                      synchronizations, and synchronous copies);
  launches            device kernels;
  device_ops          the 10 kernels that took the most device time;
  idle_gaps           device idle time grouped by the runtime call the host
                      was in when the gap opened, the 10 largest groups.
"""

from __future__ import annotations

import bisect
import re

import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuStreamSynchronize", "cuCtxSynchronize",
              "cuEventSynchronize", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2")


def profile(cuda: bool):
    """A profiler of the device's activity only (no host op events, which
    would slow the window); on the CPU, of host ops."""
    from torch.profiler import ProfilerActivity
    act = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    return torch.profiler.profile(activities=act)


def base_name(name: str) -> str:
    """``void ns::kernel<T>(args)`` -> ``kernel``."""
    head = re.split(r"[(<]", name, maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every trace event."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        yield e.name(), e.device_type() == DeviceType.CUDA, s, \
            s + e.duration_ns()


def reduce(prof, iterations: int) -> dict:
    dev, host = [], []
    for name, on_dev, s, t in _events(prof):
        (dev if on_dev else host).append((s, t, name))
    dev.sort()
    kernels: dict[str, list] = {}
    busy = 0
    launches = 0
    cur_s = cur_t = None
    gaps = []
    for s, t, name in dev:
        kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
        if kind == "kernel":
            k = kernels.setdefault(base_name(name), [0, 0.0])
            k[0] += 1
            k[1] += (t - s) * 1e-9
            launches += 1
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    runtime: dict[str, int] = {}
    for _, _, name in host:
        if name.startswith("cu"):
            runtime[name] = runtime.get(name, 0) + 1
    syncs = sum(runtime.get(c, 0) for c in SYNC_CALLS)
    # each idle gap under the runtime call the host was in when it opened,
    # or the last one it had left
    calls = sorted((s, t, n) for s, t, n in host if n.startswith("cu"))
    starts = [c[0] for c in calls]
    by_call: dict[str, float] = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        if i < 0:
            label = "before the first runtime call"
        else:
            label = ("in " if calls[i][1] >= g0 else "after ") + calls[i][2]
        by_call[label] = by_call.get(label, 0.0) + (g1 - g0) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"busy_s": busy * 1e-9, "kernels": kernels, "runtime": runtime, "syncs": syncs,
            "launches": launches, "iterations": iterations,
            "device_ops": [[n, v[1]] for n, v in top],
            "idle_gaps": sorted(([k, v] for k, v in by_call.items()),
                                key=lambda kv: -kv[1])[:10]}
