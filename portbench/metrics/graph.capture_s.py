"""graph.capture_s: the seconds the window's sample() call spent capturing
its draw step (the program's timings['capture_s'])."""


def read(ctx):
    return ctx.run.get("capture_s")
