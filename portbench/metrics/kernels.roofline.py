"""kernels.roofline (%): the summed least times of the hand-written
kernels' launches that the model counts in the traced stretch (its
``launch_work`` at this process's shapes, over portbench/roofline.py's
peaks), over their summed device times."""


def read(ctx):
    t = ctx.trace
    if t is None or t.counted_s <= 0.0:
        return None
    return 100.0 * t.bound_s / t.counted_s
