"""ess_per_s: the sum over the collected scalars of their rank-normalised
split bulk ESS, over the window's seconds (the harness's clock), per GPU."""


def read(ctx):
    r = ctx.run
    return r["ess_sum"] / r["window_s"] / r["gpus"]
