"""Wall milliseconds of the pose's init (span ``track.init``: RANSAC PnP
with its host reads) per tracked frame of the traced pass: PnP's cost on
the critical path. None where the program records no tracking spans."""

from perfbench import spans_tracking


def read(ctx):
    tr = ctx.get("trace")
    return spans_tracking.metrics(tr and tr.get("tracking_spans")).get(
        "pnp_ms_per_frame.nonrigid")
