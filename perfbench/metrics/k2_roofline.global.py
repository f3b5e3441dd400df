"""K2 (the backward compositing kernel, csrc/composite_bwd.cu) against its
frozen bound over the traced window of the global stage, in %: the sum
over the window's renders of max(bytes / bandwidth, operations / float32
peak) (perfbench/work/counts.py), over K2's device time by name."""

from perfbench.work import counts

KERNEL = "composite_bwd_kernel"


def read(ctx):
    work, tr = ctx.get("work"), ctx.get("trace")
    peak = counts.peaks(ctx["device_kind"])
    k = tr["kernels"].get(KERNEL) if tr else None
    if not work or peak is None or not k or k[1] <= 0:
        return None
    return 100.0 * counts.window_bound_s(work, counts.k2, peak) / k[1]
