"""min_ess_per_s: the least bulk ESS among the collected scalars, over the
window's seconds, per GPU."""


def read(ctx):
    r = ctx.run
    return r["ess_min"] / r["window_s"] / r["gpus"]
