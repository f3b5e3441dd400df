"""Device idle milliseconds that the join of spans and trace puts down to
span ``track`` and the spans under it, per tracked frame of the traced
pass. None where the program records no tracking spans."""

from perfbench import spans_tracking


def read(ctx):
    tr = ctx.get("trace")
    return spans_tracking.metrics(tr and tr.get("tracking_spans")).get(
        "track_idle_ms_per_frame.nonrigid")
