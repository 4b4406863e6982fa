"""The port's hier_glm Poisson family end to end on the CPU against
nestmc.sample on the same data, and the Geweke tier of its Newton path.

- The fused Poisson Newton step's plain version, on the data and schedule
  of tests/test_torch_hier_glm_slice.py (16 groups x 10 obs, p = 2, 16
  chains, 200/400, invgamma tau): the posterior means of mu and log tau
  agree within 4 combined MCSEs, the mean beta acceptance within 0.05.
- The twin of tests/test_hier_glm_newton.py:186 (slow there, tier-1 here:
  the port's CPU sweep runs it in seconds): successive-conditional
  (y ~ lik, state ~ one sweep) against marginal-conditional (exact prior
  and one likelihood draw) moments by z-test, |z| < 5, G=3, n=4, p=2, 256
  chains, 400 iterations (100 burn-in), 200,000 prior draws. The
  harness rebuilds the carried (v, g) from each new y and keeps the frozen
  Hessian of the initial prior draw (the Poisson Hessian does not read
  y), as tests/test_torch_geweke_newton.py does.
"""

import dataclasses

import torch

import nestmc_torch
from nestmc_torch.kernels import gibbs
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.models import make_hier_glm, synth_glm
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401
from tests.test_torch_geweke import geweke_zscores
from tests.test_torch_hier_glm_slice import posterior_means_agree


def test_poisson_posterior_means_agree():
    posterior_means_agree("poisson")


GQ, NQ, PQ, CQ, M, BURN, REPS = 3, 4, 2, 256, 400, 100, 200_000


def _stats(state, y):
    tau = torch.exp(state["log_tau"])
    return {
        "mu0": state["mu"][:, 0], "mu02": state["mu"][:, 0] ** 2,
        "tau0": tau[:, 0], "tau02": tau[:, 0] ** 2,
        "beta00": state["beta"][:, 0, 0],
        "beta002": state["beta"][:, 0, 0] ** 2,
        "ymean": y.mean(dim=(-2, -1)),
    }


def _sample_y(rng, beta, x):
    """y (C, G, n) ~ Poisson(exp(eta)), the rate clipped at 1e6: the prior's
    tails overflow exp(eta) in a few replicas; both simulators use it."""
    eta = torch.einsum("cgp,gnp->cgn", beta, x)
    return rng.poisson(torch.exp(eta).clamp(0.0, 1e6))


def test_geweke_glm_newton_poisson():
    data0, _ = synth_glm(13, family="poisson", G=GQ, n=NQ, p=PQ,
                         device="cpu")
    model = make_hier_glm(data0, family="poisson", tau_prior="invgamma")
    rng = SweepRNG(0, "cpu")
    st_mc = model.prior_sample(rng, data0, REPS)
    mc = _stats(st_mc, _sample_y(rng, st_mc["beta"], data0.x))

    cfg = nestmc_torch.SamplerConfig(
        kernel=nestmc_torch.KernelConfig(algorithm="newton"),
        run=nestmc_torch.RunConfig(chains=CQ, log_every_segment=False))
    sweep = gibbs.make_sweep(model, cfg)
    rng = SweepRNG(2, "cpu")
    position = model.prior_sample(rng, data0, CQ)
    kstate = init_kernel_state(model, cfg, rng, data0, position=position)
    self_vg = model.cond_cached_grad["beta"][0]
    sums = None
    for t in range(M):
        y = _sample_y(rng, kstate.position["beta"], data0.x)
        # one replica's data a chain: the model reads y (C, G, n) through
        # its obs passes, which broadcast over the chains axis
        d = dataclasses.replace(data0, y=y)
        v, g = self_vg(kstate.position["beta"], d)
        kstate = dataclasses.replace(kstate, cache={
            **kstate.cache,
            "beta": {"v": v, "g": g, "h": kstate.cache["beta"]["h"]}})
        kstate = sweep(kstate, d, False, rng)
        if t >= BURN:
            s = _stats(kstate.position, y)
            sums = s if sums is None else {k: sums[k] + s[k] for k in s}
    sc = {k: v / (M - BURN) for k, v in sums.items()}
    zs = geweke_zscores(mc, sc)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke glm newton poisson: worst |z| {worst:.3f}")
    assert worst < 5.0, zs
