"""The port's nested Poisson sampler vs nestmc's, end to end on the CPU, on
the same data, for the three subject updates (RW-MH, MALA, Newton-MH).

The two packages draw different random numbers (threefry vs torch), so the
chains differ; the posteriors must agree. G=8 groups x 3 subjects x n=10
obs, p=2, 32 chains, 200 warmup sweeps, 400 draws, the inverse-gamma tau
priors of the config-3 presets, both interweaving moves, adapted scales,
streamed all-param R-hat; the reference on loglik_impl="jnp". Posterior
means of mu, log_tau_g and log_tau_s agree within 4 combined MCSEs, and
the mean acceptance of beta_s and of both moves within 0.05.
"""

import numpy as np
import pytest

import jax

import nestmc
from nestmc.models import make_nested_poisson as j_make, synth_poisson3
import nestmc_torch
from nestmc_torch.data import from_numpy3
from nestmc_torch.models import make_nested_poisson

C, G, SPG, N, P = 32, 8, 3, 10, 2
COLLECT = {"mu": None, "log_tau_g": None, "log_tau_s": None}


@pytest.fixture(scope="module", params=["rwmh", "mala", "newton"])
def posteriors(request):
    data, _ = synth_poisson3(jax.random.key(5), G=G, subjects_per_group=SPG,
                             n=N, p=P)
    kernel = dict(algorithm=request.param)
    run = dict(chains=C, warmup=200, draws=400, seed=3, full_rhat=True,
               collect=COLLECT, log_every_segment=False)
    jpost = nestmc.sample(
        j_make(data, tau_prior="invgamma", loglik_impl="jnp"), data,
        nestmc.SamplerConfig(kernel=nestmc.KernelConfig(**kernel),
                             run=nestmc.RunConfig(**run)),
    )
    tdata = from_numpy3(data.x, data.y, data.mask, data.subject_group, G,
                        device="cpu")
    tpost = nestmc_torch.sample(
        make_nested_poisson(tdata, tau_prior="invgamma"), tdata,
        nestmc_torch.SamplerConfig(kernel=nestmc_torch.KernelConfig(**kernel),
                                   run=nestmc_torch.RunConfig(**run)),
    )
    return jpost, tpost


def test_posterior_means_agree(posteriors):
    jpost, tpost = posteriors
    for name in COLLECT:
        jd, td = jpost.diagnostics()[name], tpost.diagnostics()[name]
        jm, tm = np.asarray(jd["mean"]), td["mean"].numpy()
        se = np.sqrt(np.asarray(jd["mcse_mean"]) ** 2
                     + td["mcse_mean"].numpy() ** 2)
        assert np.all(np.abs(jm - tm) < 4 * se), (name, jm, tm, se)


def test_acceptance_and_rhat_coverage_agree(posteriors):
    jpost, tpost = posteriors
    for k in ("beta_s", "asis_tau_g", "asis_tau_s"):
        ja = float(np.mean(np.asarray(jpost.accept_rates[k])))
        ta = float(tpost.accept_rates[k].mean())
        assert abs(ja - ta) < 0.05, (k, ja, ta)
    assert set(tpost.full_rhat) == set(jpost.full_rhat)
    assert tpost.full_rhat["beta_s"].shape == (G * SPG, P)
    assert tpost.full_rhat["beta_g"].shape == (G, P)
    assert tpost.draws["mu"].shape == (C, 400, P)
    at = tpost.worst_rhat_at()
    assert at["rhat"] == tpost.worst_rhat()
    assert at["block"] in tpost.full_rhat or at["block"] in COLLECT
