"""The whole mapping iteration's share of the card's float32 peak over the
traced window of the global stage, in %: the frozen operations of each
iteration (perfbench/work/counts.py, from the geometry of the frame it
rendered) summed over the window's iterations, over the window's seconds,
over the peak."""

from perfbench.work import counts


def read(ctx):
    work, peak = ctx.get("work"), counts.peaks(ctx["device_kind"])
    if not work or peak is None or ctx["window_s"] <= 0:
        return None
    ops = 0
    for frame, n in work["renders"].items():
        f = work["per_frame"][frame]
        ops += n * counts.mapping_step(f["blended"], f["stopped"],
                                       f["gaussians"], work["active"],
                                       work["height"], work["width"],
                                       work["boxes"])
    return 100.0 * ops / ctx["window_s"] / peak["f32_flops"]
