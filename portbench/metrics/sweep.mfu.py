"""sweep.mfu (%): the least time the work of one sweep of the configured
algorithm needs on this process's share (the model's ``sweep_work``,
counted whatever kernels run it), over the measured time per sweep of the
traced stretch."""

from portbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None or not t.sweeps or t.stretch_s <= 0.0:
        return None
    least = roofline.bound_ms(*ctx.cell.model.sweep_work(ctx.cell.config,
                                                         ctx.shapes))
    return 100.0 * least / (1e3 * t.stretch_s / t.sweeps)
