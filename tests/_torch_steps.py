"""The six fused step wrappers (seven launch modes) on one set of inputs,
for the offset-parity tests: a step run on a chain slice or a unit slice
of the inputs, told its offsets (the rng's ``chains``, the ``units``
argument), gives that slice of the full-width call (the plain versions in
test_torch_sharding.py, the kernels in test_torch_cuda.py). No jax here:
the card's test host has none."""

import torch

from nestmc_torch.ops.cuda.mala_accept import fused_mala_logistic_step
from nestmc_torch.ops.cuda.mh_accept import fused_rwmh_logistic_step
from nestmc_torch.ops.cuda.newton_accept import fused_newton_logistic_step
from nestmc_torch.ops.cuda.poisson_accept import (
    fused_mala_poisson_step,
    fused_newton_poisson_step,
    fused_rwmh_poisson_step,
)

STEPS = ("rwmh", "mala", "newton", "newton_frozen", "pois_rwmh",
         "pois_mala", "pois_newton", "pois_newton_frozen")


def step_inputs(C, U, n, p, name, device, seed=11):
    """Every operand any step takes, (C chains, U units), on ``device``."""
    g = torch.Generator().manual_seed(seed)
    T = p * (p + 1) // 2

    def rn(*s, scale=0.3):
        return scale * torch.randn(*s, generator=g)

    x = rn(U, n, p, scale=0.5)
    x[:, :, 0] = 1.0
    if name.startswith("pois"):
        y = torch.poisson(torch.full((U, n), 1.5), generator=g)
    else:
        y = (torch.rand(U, n, generator=g) < 0.5).float()
    h = torch.zeros(C, U, T)
    for i in range(p):
        h[..., i * (i + 1) // 2 + i] = 2.0 + torch.rand(C, U, generator=g)
    a = dict(beta=rn(C, U, p), v=rn(C, U), g=rn(C, U, p), h=h,
             ls=rn(C, U) - 1.0, mu=rn(C, p), lt=rn(C, p) - 0.5,
             bgs=rn(C, U, p), x=x, y=y, mask=torch.ones(U, n))
    return {k: v.to(device) for k, v in a.items()}


def cut_inputs(a, cs, us):
    """The operands of chains ``cs`` and units ``us`` (slices)."""
    out = {}
    for k, v in a.items():
        if k in ("x", "y", "mask"):
            out[k] = v[us].contiguous()
        elif k in ("mu", "lt"):
            out[k] = v[cs].contiguous()
        else:
            out[k] = v[cs, us].contiguous()
    return out


def run_step(name, a, rng, cs=None, us=None, C=None, U=None):
    """The step's outputs that carry (chain, unit) axes. With slices
    ``cs`` / ``us`` of C chains / U units, ``a`` holds that part and the
    step is told where it lies."""
    if cs is not None and (cs.start or 0) != 0:
        rng.chains = (cs.start, C)
    units = None
    if us is not None and (us.start or 0) != 0:
        units = (us.start, U)
    frozen = name.endswith("_frozen")
    d = (a["x"], a["y"], a["mask"])
    base = name[:-len("_frozen")] if frozen else name
    if base == "rwmh":
        out = fused_rwmh_logistic_step(a["beta"], a["v"], a["ls"], a["mu"],
                                       a["lt"], *d, rng=rng, units=units)
    elif base == "mala":
        out = fused_mala_logistic_step(a["beta"], a["v"], a["g"], a["ls"],
                                       a["mu"], a["lt"], *d, rng=rng,
                                       units=units)
    elif base == "newton":
        out = fused_newton_logistic_step(
            a["beta"], a["v"], a["g"], a["h"], a["ls"], a["mu"], a["lt"],
            *d, rng=rng, frozen=frozen, units=units)
    elif base == "pois_rwmh":
        out = fused_rwmh_poisson_step(a["beta"], a["v"], a["ls"], a["bgs"],
                                      a["lt"], *d, rng=rng, units=units)
    elif base == "pois_mala":
        out = fused_mala_poisson_step(a["beta"], a["v"], a["g"], a["ls"],
                                      a["bgs"], a["lt"], *d, rng=rng,
                                      units=units)
    else:
        out = fused_newton_poisson_step(
            a["beta"], a["v"], a["g"], a["h"], a["ls"], a["bgs"], a["lt"],
            *d, rng=rng, frozen=frozen, units=units)
    return [t for t in out if t.ndim >= 2]
