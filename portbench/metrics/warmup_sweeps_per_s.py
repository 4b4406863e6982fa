"""warmup_sweeps_per_s: the configuration's warmup sweeps over the
harness's clock around the warmup call in set-up (ended by a
synchronise)."""


def read(ctx):
    r = ctx.run
    return r["warmup_sweeps"] / r["warmup_s"]
