"""plain.ms_per_sweep: the device time per sweep of every operation that
is neither a hand-written kernel nor NCCL's (PyTorch's kernels, copies
and fills), in the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.sweeps:
        return None
    return 1e3 * t.seconds["plain"] / t.sweeps
