"""K1 (the forward compositing kernel, csrc/composite_fwd.cu) against its
frozen bound over the traced window of the global stage, in %: the sum
over the window's renders of max(bytes / bandwidth, operations / float32
peak) (perfbench/work/counts.py), over K1's device time by name."""

from perfbench.work import counts

KERNEL = "composite_fwd_kernel"


def read(ctx):
    work, tr = ctx.get("work"), ctx.get("trace")
    peak = counts.peaks(ctx["device_kind"])
    k = tr["kernels"].get(KERNEL) if tr else None
    if not work or peak is None or not k or k[1] <= 0:
        return None
    return 100.0 * counts.window_bound_s(work, counts.k1, peak) / k[1]
