"""Device milliseconds of the kernels issued inside span ``track.mask``
(the epipolar rigidity mask) per tracked frame of the traced pass. None
where the program records no tracking spans."""

from perfbench import spans_tracking


def read(ctx):
    tr = ctx.get("trace")
    return spans_tracking.metrics(tr and tr.get("tracking_spans")).get(
        "rigid_mask_dev_ms_per_frame.nonrigid")
