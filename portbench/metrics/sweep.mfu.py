"""sweep.mfu (%): the least time the work of one sweep of the configured
algorithm needs on this process's share (one group step in its sampling
mode and one interweave logp_grad pass, counted by portbench/roofline.py
whatever kernels run them), over the measured time per sweep of the traced
stretch."""

from portbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None or not t.sweeps or t.stretch_s <= 0.0:
        return None
    c, s = ctx.cell.config, ctx.shapes
    fold = c["full_rhat_thin"] == 1
    step = {"newton": "newton_step_frozen", "mala": "mala_step"}[
        c["algorithm"]]
    work = [roofline.kernel_work(step, s["C"], s["G"], s["n"], s["p"],
                                 fold=fold),
            roofline.kernel_work("logp_grad", s["C"], s["G"], s["n"],
                                 s["p"])]
    least = roofline.bound_ms(sum(b for b, _ in work),
                              sum(o for _, o in work))
    return 100.0 * least / (1e3 * t.stretch_s / t.sweeps)
