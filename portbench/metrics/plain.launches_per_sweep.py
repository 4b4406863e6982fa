"""plain.launches_per_sweep: the device operations per sweep that are
neither hand-written kernels nor NCCL's, in the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.sweeps:
        return None
    return t.launches["plain"] / t.sweeps
