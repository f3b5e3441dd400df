"""Blocking CUDA runtime calls (synchronizations and synchronous copies)
per frame of the progressive stage, from the traced window."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["iterations"] or not tr["launches"]:
        return None
    return tr["syncs"] / tr["iterations"]
