"""setup_s: seconds from the process's start (the launcher's, on four
chips) to the window's start: imports, data, the kernels' build or load,
warmup and the calibration of the draw step."""


def read(ctx):
    return ctx.run["setup_s"]
