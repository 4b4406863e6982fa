"""sweeps_per_s: the sampling sweeps the window completed (draws x thin),
over its seconds; the whole run's, on four chips too."""


def read(ctx):
    r = ctx.run
    return r["sweeps"] / r["window_s"]
