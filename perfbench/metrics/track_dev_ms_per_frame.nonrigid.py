"""Device milliseconds of every kernel issued inside span ``track``
(the init, the mask, Gauss-Newton and the Adam steps' renders, losses and
gradients, the program's own kernels included) per tracked frame of the
traced pass. None where the program records no tracking spans."""

from perfbench import spans_tracking


def read(ctx):
    tr = ctx.get("trace")
    return spans_tracking.metrics(tr and tr.get("tracking_spans")).get(
        "track_dev_ms_per_frame.nonrigid")
