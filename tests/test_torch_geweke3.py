"""Geweke joint-distribution tier for the port's three-level nested
Poisson GLMM: the twin of tests/test_geweke3.py, on the CPU plain paths in
tier-1.

The same harness as tests/test_torch_geweke.py, against the port's real
``make_nested_poisson`` (its fused RW-MH subject step's plain version, the
exact conjugate beta_g and mu draws, both interweaving moves; under the
inverse-gamma prior the conjugate draws of both log tau levels): the
per-replica responses ride the chains axis, y (C, S, n), while x and mask
stay (S, n, ...). The carried subject loglik depends on y, so it is
rebuilt from the new y before every sweep, as the reference does. Power
check: a conjugate log_tau_g draw with the wrong sufficient-statistic
scaling (quad/4 in place of quad/2) must give |z| > 6. Sizes, priors and
thresholds are the reference's; the seeds are this file's, fixed once.
"""

import dataclasses

import pytest
import torch

from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.kernels.gibbs import make_sweep
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.models import make_nested_poisson, synth_poisson3
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401
from tests.test_torch_geweke import geweke_zscores

G, SPG, N, P = 3, 2, 3, 2     # groups, subjects a group, obs, covariates
S = G * SPG
C = 512                       # independent replicas
M = 400                       # successive-conditional iterations
BURN = 100
REPS = 200_000
# tight priors keep the Poisson rates of prior draws in float32 range
PRIORS = dict(prior_mu_scale=0.4, prior_tau_scale=0.3)
IG = dict(tau_ig_shape=3.0, tau_ig_scale=0.3)


def _make(tau_prior):
    data, _ = synth_poisson3(0, G=G, subjects_per_group=SPG, n=N, p=P,
                             device="cpu")
    return make_nested_poisson(data, tau_prior=tau_prior, **PRIORS,
                               **IG), data


def _sample_y(rng, beta_s, data):
    """(C, S, p) beta_s -> (C, S, n) Poisson responses given the fixed x."""
    eta = torch.einsum("snp,csp->csn", data.x, beta_s)
    rate = torch.exp(eta).clamp_max(1e6)   # guard the float32 prior tail
    return rng.poisson(rate) * data.mask


def _test_functions(state, y):
    tau_g = torch.exp(state["log_tau_g"][:, 0])
    tau_s = torch.exp(state["log_tau_s"][:, 0])
    bg, bs, mu = state["beta_g"], state["beta_s"], state["mu"]
    return {
        "mu": mu[:, 0],
        "mu2": mu[:, 0] ** 2,
        "tau_g": tau_g,
        "tau_g2": tau_g**2,
        "tau_s": tau_s,
        "tau_s2": tau_s**2,
        "beta_g00": bg[:, 0, 0],
        "beta_g00sq": bg[:, 0, 0] ** 2,
        "beta_s00": bs[:, 0, 0],
        "beta_s00sq": bs[:, 0, 0] ** 2,
        "beta_g_x_mu": bg[:, 0, 0] * mu[:, 0],
        "ymean": y.mean(dim=(1, 2)),
        "y2": (y**2).mean(dim=(1, 2)),
        "by": bs[:, 0, 0] * y[:, 0].mean(dim=-1),
    }


def _marginal_conditional(model, data, seed):
    rng = SweepRNG(seed, "cpu")
    state = model.prior_sample(rng, data, REPS)
    return _test_functions(state, _sample_y(rng, state["beta_s"], data))


def _successive_conditional(model, data, seed):
    cfg = SamplerConfig(
        kernel=KernelConfig(scale_per_unit=True, algorithm="rwmh"),
        run=RunConfig(chains=C, log_every_segment=False),
    )
    sweep = make_sweep(model, cfg)
    rng = SweepRNG(seed, "cpu")
    kstate = init_kernel_state(model, cfg, rng, data)
    kstate = dataclasses.replace(kstate,
                                 position=model.prior_sample(rng, data, C))
    self_fn = model.cond_cached["beta_s"][0]
    sums = None
    for t in range(M):
        y = _sample_y(rng, kstate.position["beta_s"], data)
        data_t = dataclasses.replace(data, y=y)
        # the carried loglik depends on y, which just changed: new data,
        # new cache
        cache = {**kstate.cache,
                 "beta_s": self_fn(kstate.position["beta_s"], data_t)}
        kstate = sweep(dataclasses.replace(kstate, cache=cache), data_t,
                       False, rng)
        if t >= BURN:
            stats = _test_functions(kstate.position, y)
            sums = stats if sums is None else {
                k: sums[k] + v for k, v in stats.items()}
    return {k: v / (M - BURN) for k, v in sums.items()}


def _zscores(model, data, seed):
    return geweke_zscores(_marginal_conditional(model, data, seed),
                          _successive_conditional(model, data, seed + 1))


@pytest.mark.parametrize("tau_prior", ["halfnormal", "invgamma"])
def test_geweke3_correct_sampler_passes(tau_prior):
    """halfnormal: the MH tau blocks, the conjugate mu and beta_g draws and
    both interweaving moves; invgamma: also the conjugate inverse-gamma
    draws of both scale levels."""
    model, data = _make(tau_prior)
    zs = _zscores(model, data, seed=200)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke3 {tau_prior}: worst |z| {worst:.3f}")
    assert worst < 5.0, f"Geweke-3 z-scores ({tau_prior}) {zs}"


def test_geweke3_detects_broken_conjugate_tau():
    """Power check: quad/4 in place of quad/2 in the inverse-gamma rate of
    the conjugate log_tau_g draw."""
    model, data = _make("invgamma")

    def broken_log_tau_g(rng, state, data_):
        bg, mu = state["beta_g"], state["mu"]
        quad = (bg**2).sum(dim=1) - 2.0 * mu * bg.sum(dim=1) + G * mu * mu
        rate = IG["tau_ig_scale"] + 0.25 * quad     # the bug: 0.5 * quad
        g = rng.gamma(IG["tau_ig_shape"] + 0.5 * G, quad.shape)
        return torch.clamp(0.5 * (torch.log(rate) - torch.log(g)),
                           -12.0, 12.0)

    broken = dataclasses.replace(
        model,
        gibbs_draws={**model.gibbs_draws, "log_tau_g": broken_log_tau_g},
    )
    zs = _zscores(broken, data, seed=210)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke3 broken conjugate tau: worst |z| {worst:.3f}")
    assert worst > 6.0, (
        f"Geweke-3 failed to detect a broken conjugate draw: z-scores {zs}"
    )
