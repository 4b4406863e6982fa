"""collectives.ms_per_sweep: NCCL's kernels' device time per sweep on rank
0 in the traced stretch; nothing where no collective ran."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.sweeps or not t.launches["nccl"]:
        return None
    return 1e3 * t.seconds["nccl"] / t.sweeps
