"""device.idle_share (%): 1 - the time a device operation ran over the
traced stretch's length, both from the profiler, averaged over the
ranks."""


def read(ctx):
    r = ctx.run
    if ctx.trace is None or not r.get("stretch_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["stretch_s"])
