"""kernels.ms_per_sweep: the hand-written kernels' device time per sweep
in the traced stretch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.sweeps or not t.launches["kernels"]:
        return None
    return 1e3 * t.seconds["kernels"] / t.sweeps
