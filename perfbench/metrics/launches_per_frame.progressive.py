"""Device kernels launched per frame of the progressive stage (tracking,
and mapping or the test frame's render), from the traced window."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["iterations"] or not tr["launches"]:
        return None
    return tr["launches"] / tr["iterations"]
