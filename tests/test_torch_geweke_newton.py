"""Geweke tier for the port's Newton-MH update: the twin of
tests/test_geweke_newton.py, on the CPU plain paths in tier-1.

The harness of tests/test_torch_geweke.py on the Bernoulli-logit
calibration twin (tests/test_torch_calibration.py): the conditional of
the per-group logit theta_g is not Gaussian at n = 3 observations, so the
Newton acceptance ratio (the proposal's position-dependent mean,
covariance and normalisation) is exercised; theta runs
kernels/newton.newton_update on scalar units with analytic hooks, mu and
log_tau RW-MH.

Power checks, each injected by replacing the 'newton' entry of
nestmc_torch.kernels.gibbs._UPDATES inside the test only: the update
without its asymmetric-proposal correction, and the frozen-metric kernel
fed a Hessian refreshed from the current position every iteration (one
metric both ways, no log-det ratio), must each give |z| > 6. The refresh
tiers run with newton_freeze off: the harness rebuilds the whole (v, g, h)
cache from the new data before each sweep. The frozen tier keeps the
Hessian of the initial prior draw, a constant, as at warmup end. Sizes and
thresholds are the reference's; the seeds are this file's, fixed once.
"""

import dataclasses

import pytest
import torch

from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.kernels import gibbs
from nestmc_torch.kernels.rwmh import accept_prob, select_accepted
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.ops.smallchol import chol_packed, solve_upper_t, spd_solve
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import (  # noqa: F401
    make_logistic_calibration_model,
    one_thread,
    sample_y_logit,
)
from tests.test_torch_geweke import geweke_zscores

G, N = 4, 3
C = 512
M = 400
BURN = 100
REPS = 200_000


def _test_functions(state, y):
    tau = torch.exp(state["log_tau"])
    th = state["theta"]
    return {
        "mu": state["mu"],
        "mu2": state["mu"] ** 2,
        "tau": tau,
        "tau2": tau**2,
        "theta0": th[:, 0],
        "theta02": th[:, 0] ** 2,
        "theta03": th[:, 0] ** 3,
        "theta_mean": th.mean(dim=1),
        "ybar": y.mean(dim=(1, 2)),
        "ty": th[:, 0] * y[:, 0].mean(dim=-1),
    }


def _broken_newton_update(rng, block, model, position, log_scale, data,
                          cache=None, frozen=False):
    """newton_update without the asymmetric-proposal correction: accepts
    on the bare density ratio (the power-check transition)."""
    value = position[block.name]                       # (C, G) scalar units
    self_vgh, rest_vgh = model.cond_cached_newton[block.name]
    sv, sg, sh = self_vgh(value, data)
    rv, rg, rh = rest_vgh(value, position, data)
    L = chol_packed((sh + rh)[..., None], 1)
    mean = value[..., None] + spd_solve(L, (sg + rg)[..., None], 1)
    eps = rng.normal(mean.shape)
    prop = (mean + solve_upper_t(L, eps, 1))[..., 0]
    sv2, _, _ = self_vgh(prop, data)
    rv2, _, _ = rest_vgh(prop, position, data)
    log_alpha = (sv2 + rv2) - (sv + rv)               # no q correction
    accept = rng.log_uniform(log_alpha.shape) < log_alpha
    new_value = select_accepted(accept, prop, value, block)
    if cache is not None:
        # the harness rebuilds the cache from the new data before every
        # sweep; keep its structure
        cache = {"v": torch.where(accept, sv2, cache["v"]),
                 "g": cache["g"], "h": cache["h"]}
    return new_value, accept_prob(log_alpha), cache


def _successive_conditional(model, seed, frozen=False,
                            frozen_refresh_bug=False):
    """frozen: the frozen-metric sampling kernel, its likelihood Hessian
    held at the initial prior draw's (this model's Hessian n sig (1 - sig)
    does not depend on y, so a constant one is consistent); only v and g
    are rebuilt when the data change. frozen_refresh_bug: the frozen
    kernel with the Hessian rebuilt from the current position every
    iteration, the invalid pattern the frozen tier must detect."""
    cfg = SamplerConfig(
        kernel=KernelConfig(scale_per_unit=True,
                            newton_freeze=frozen or frozen_refresh_bug),
        run=RunConfig(chains=C, log_every_segment=False),
    )
    sweep = gibbs.make_sweep(model, cfg)
    rng = SweepRNG(seed, "cpu")
    position = model.prior_sample(rng, None, C)
    y = sample_y_logit(rng, position["theta"], N)
    kstate = init_kernel_state(model, cfg, rng, {"y": y}, position=position)
    self_vgh, _ = model.cond_cached_newton["theta"]
    keep_h = frozen and not frozen_refresh_bug
    sums = None
    for t in range(M):
        y = sample_y_logit(rng, kstate.position["theta"], N)
        v, g, h = self_vgh(kstate.position["theta"], {"y": y})
        if keep_h:
            h = kstate.cache["theta"]["h"]
        kstate = dataclasses.replace(
            kstate, cache={**kstate.cache, "theta": {"v": v, "g": g, "h": h}})
        kstate = sweep(kstate, {"y": y}, False, rng)
        if t >= BURN:
            stats = _test_functions(kstate.position, y)
            sums = stats if sums is None else {
                k: sums[k] + v for k, v in stats.items()}
    return {k: v / (M - BURN) for k, v in sums.items()}


def _zscores(seed, frozen=False, frozen_refresh_bug=False):
    model = make_logistic_calibration_model(G, N)
    rng = SweepRNG(seed, "cpu")
    state = model.prior_sample(rng, None, REPS)
    mc = _test_functions(state, sample_y_logit(rng, state["theta"], N))
    sc = _successive_conditional(model, seed + 1, frozen=frozen,
                                 frozen_refresh_bug=frozen_refresh_bug)
    return geweke_zscores(mc, sc)


def test_geweke_newton_passes():
    zs = _zscores(seed=300)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke newton: worst |z| {worst:.3f}")
    assert worst < 5.0, f"Geweke z-scores (newton) {zs}"


def test_geweke_newton_dropped_q_detected(monkeypatch):
    monkeypatch.setattr(gibbs, "_UPDATES",
                        {**gibbs._UPDATES, "newton": _broken_newton_update})
    zs = _zscores(seed=310)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke newton dropped q: worst |z| {worst:.3f}")
    assert worst > 6.0, (
        f"Geweke failed to detect a missing Newton q-correction: {zs}"
    )


def test_geweke_newton_frozen_passes():
    """The frozen-metric sampling kernel (a constant likelihood Hessian,
    KernelConfig.newton_freeze) leaves the joint invariant."""
    zs = _zscores(seed=320, frozen=True)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke newton frozen: worst |z| {worst:.3f}")
    assert worst < 5.0, f"Geweke z-scores (frozen newton) {zs}"


def test_geweke_newton_frozen_refresh_bug_detected():
    """Power check of the frozen tier: the Hessian refreshed from the
    current position each iteration while the kernel treats the metric as
    constant breaks detailed balance."""
    zs = _zscores(seed=330, frozen_refresh_bug=True)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke newton frozen-refresh bug: worst |z| {worst:.3f}")
    assert worst > 6.0, (
        f"Geweke failed to detect the stale-metric frozen-Newton bug: {zs}"
    )
