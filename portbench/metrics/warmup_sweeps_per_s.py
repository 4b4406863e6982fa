"""warmup_sweeps_per_s: the configuration's warmup sweeps over the
harness's clock around the warmup call in set-up (ended by a
synchronise), which follows a short warmup of the same step, so that the
process's first-call costs are set-up's and not this clock's."""


def read(ctx):
    r = ctx.run
    return r["warmup_sweeps"] / r["warmup_s"]
