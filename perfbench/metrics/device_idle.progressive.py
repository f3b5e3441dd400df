"""Share of the traced window of the progressive stage (one pass over the
traffic's ``trace_frames``) in which no operation ran on the device (100 -
the union of kernel and copy intervals over the window), in %."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or ctx["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"])
