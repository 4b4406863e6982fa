"""Geweke (2004) "getting it right" tier on the port: the twin of
tests/test_geweke.py, run on the CPU plain paths in tier-1.

Marginal-conditional simulator: (theta, y) ~ p(theta) p(y | theta), exact.
Successive-conditional simulator: theta ~ p(theta) once, then alternate
y ~ p(y | theta) and one port sweep (kernels/gibbs.make_sweep, adapt off)
theta ~ T(theta | y). Both draw from the same joint if and only if the
sweep leaves p(theta | y) invariant, so the means of the test functions
must agree by a z-test: |z| < 5 for a correct sampler. C = 512
independent replicas ride the chains axis, each with its own simulated
data (the chain-batched calibration twin, tests/test_torch_calibration.py).
Power checks: the missing log-tau Jacobian and the Langevin interweaving
move without its q correction must each give |z| > 6. Sizes, thresholds
and the interweaving scale are the reference's; the seeds are this file's,
fixed once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.kernels.gibbs import make_sweep
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import (  # noqa: F401
    make_broken_model,
    make_calibration_model,
    one_thread,
    sample_y,
)

G, N = 4, 3
C = 512          # independent replicas
M = 400          # successive-conditional iterations
BURN = 100
REPS = 200_000   # marginal-conditional draws


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
        "theta_mean": th.mean(dim=1),
        "y00": y[:, 0, 0],
        "y2": (y**2).mean(dim=(1, 2)),
        "ty": th[:, 0] * y[:, 0].mean(dim=-1),
    }


def _marginal_conditional(model, seed):
    rng = SweepRNG(seed, "cpu")
    state = model.prior_sample(rng, None, REPS)
    return _test_functions(state, sample_y(rng, state["theta"], N))


def _successive_conditional(model, seed, algorithm="rwmh"):
    """Per-replica means of the test functions over iterations BURN..M."""
    cfg = SamplerConfig(
        kernel=KernelConfig(scale_per_unit=True, algorithm=algorithm),
        run=RunConfig(chains=C, log_every_segment=False),
    )
    sweep = make_sweep(model, cfg)
    rng = SweepRNG(seed, "cpu")
    kstate = init_kernel_state(model, cfg, rng, None)
    kstate = dataclasses.replace(kstate,
                                 position=model.prior_sample(rng, None, C))
    sums = None
    for t in range(M):
        y = sample_y(rng, kstate.position["theta"], N)
        kstate = sweep(kstate, {"y": y}, False, rng)
        if t >= BURN:
            stats = _test_functions(kstate.position, y)
            sums = stats if sums is None else {
                k: sums[k] + v for k, v in stats.items()}
    return {k: v / (M - BURN) for k, v in sums.items()}


def geweke_zscores(mc, sc):
    """z of the difference of the two simulators' means per test function;
    the successive-conditional replicas are independent, so each
    replica's mean is one draw."""
    zs = {}
    for k in mc:
        a, b = mc[k].double(), sc[k].double()
        se1 = float(a.std()) / np.sqrt(a.shape[0])
        se2 = float(b.std()) / np.sqrt(b.shape[0])
        zs[k] = (float(a.mean()) - float(b.mean())) / np.sqrt(
            se1**2 + se2**2 + 1e-12)
    return zs


def _zscores(model, seed, algorithm="rwmh"):
    return geweke_zscores(_marginal_conditional(model, seed),
                          _successive_conditional(model, seed + 1, algorithm))


@pytest.mark.parametrize("algorithm", ["rwmh", "mala"])
def test_geweke_correct_sampler_passes(algorithm):
    """The MH correction of both kernels; for MALA the sharpest check of
    the Langevin proposal's correction term."""
    zs = _zscores(make_calibration_model(G, N), seed=100,
                  algorithm=algorithm)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke {algorithm}: worst |z| {worst:.3f}")
    assert worst < 5.0, f"Geweke z-scores ({algorithm}) {zs}"


def test_geweke_grad_asis_passes():
    """The Langevin interweaving move (z-fixed target, chain-rule gradient,
    asymmetric-proposal correction) at the reference's fixed scale 1.0."""
    model = make_calibration_model(G, N, grad_asis=True, asis_init_scale=1.0)
    zs = _zscores(model, seed=120)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke grad-ASIS: worst |z| {worst:.3f}")
    assert worst < 5.0, f"Geweke z-scores (grad-ASIS) {zs}"


def test_geweke_grad_asis_broken_q_detected():
    """Power check: the same move without its q correction must fail."""
    model = make_calibration_model(G, N, grad_asis="broken-q",
                                   asis_init_scale=1.0)
    zs = _zscores(model, seed=121)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke broken q: worst |z| {worst:.3f}")
    assert worst > 6.0, (
        f"Geweke failed to detect a missing MALA q-correction: {zs}"
    )


def test_geweke_detects_broken_jacobian():
    zs = _zscores(make_broken_model(G, N), seed=110)
    worst = max(abs(z) for z in zs.values())
    print(f"geweke broken Jacobian: worst |z| {worst:.3f}")
    assert worst > 6.0, (
        f"Geweke failed to detect a missing Jacobian: z-scores {zs}"
    )
