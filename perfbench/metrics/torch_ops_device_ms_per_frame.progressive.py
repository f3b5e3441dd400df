"""Device milliseconds per frame of the progressive stage of every kernel
not built from the program's csrc/ (PyTorch's own kernels: the Gauss-Newton
solve, the rigidity mask, binning, losses, SSIM, Adam, autograd), from the
traced window."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["iterations"] or not tr["launches"]:
        return None
    own = ctx["program_kernels"]
    s = sum(v[1] for k, v in tr["kernels"].items() if k not in own)
    return 1e3 * s / tr["iterations"]
