"""The port's sampler vs nestmc's on ragged data, end to end on the CPU:
config 4's default route at a small size.

G=64 groups of 1..24 obs (two size buckets, caps 16 and 32), p=3, 32
chains, 200 warmup sweeps, 400 draws, streamed all-param R-hat.
Frozen-metric Newton-MH (invgamma tau) on the bucket route, with the
bucketed fused step. The reference runs loglik_impl="jnp" (the
jnp-segment route: the same target). tests/test_torch_ragged_slice_mala.py
holds the segment route. The two packages draw different
random numbers, so the chains differ; posterior means of mu and log_tau
agree within 4 combined MCSEs and the mean beta acceptance within 0.05.
"""

import numpy as np
import pytest

import jax

import nestmc
from nestmc.models import make_hier_logistic as j_make, synth_logistic
import nestmc_torch
from nestmc_torch.data import from_numpy_ragged
from nestmc_torch.models import make_hier_logistic

C, G, N, P = 32, 64, 24, 3
ALGORITHM, IMPL, TAU_PRIOR = "newton", "bucket", "invgamma"


@pytest.fixture(scope="module")
def posteriors():
    algorithm, impl, tau_prior = ALGORITHM, IMPL, TAU_PRIOR
    data, _ = synth_logistic(jax.random.key(5), G=G, n=N, p=P, ragged=True,
                             min_obs=1)
    kernel = dict(algorithm=algorithm, fused_accept=True)
    run = dict(chains=C, warmup=200, draws=400, seed=3, full_rhat=True,
               collect={"mu": None, "log_tau": None},
               log_every_segment=False)
    jpost = nestmc.sample(
        j_make(data, tau_prior=tau_prior, loglik_impl="jnp"), data,
        nestmc.SamplerConfig(kernel=nestmc.KernelConfig(**kernel),
                             run=nestmc.RunConfig(**run)),
    )
    tdata = from_numpy_ragged(data.x, data.y, data.segment_ids, G,
                              device="cpu")
    tmodel = make_hier_logistic(tdata, tau_prior=tau_prior, loglik_impl=impl)
    assert tmodel.loglik_impls["selected"] == impl
    fused = tmodel.fused_updates_newton if algorithm == "newton" else \
        tmodel.fused_updates_mala
    assert ("beta" in fused) == (impl == "bucket")
    tpost = nestmc_torch.sample(
        tmodel, tdata,
        nestmc_torch.SamplerConfig(kernel=nestmc_torch.KernelConfig(**kernel),
                                   run=nestmc_torch.RunConfig(**run)),
    )
    return jpost, tpost


@pytest.mark.parametrize("name", ["mu", "log_tau"])
def test_posterior_means_agree(posteriors, name):
    jpost, tpost = posteriors
    jd, td = jpost.diagnostics()[name], tpost.diagnostics()[name]
    jm, tm = np.asarray(jd["mean"]), td["mean"].numpy()
    se = np.sqrt(np.asarray(jd["mcse_mean"]) ** 2
                 + td["mcse_mean"].numpy() ** 2)
    assert np.all(np.abs(jm - tm) < 4 * se), (name, jm, tm, se)


def test_acceptance_and_streamed_rhat_agree(posteriors):
    jpost, tpost = posteriors
    ja = float(np.mean(np.asarray(jpost.accept_rates["beta"])))
    ta = float(tpost.accept_rates["beta"].mean())
    assert abs(ja - ta) < 0.05, (ja, ta)
    assert set(tpost.full_rhat) == set(jpost.full_rhat)
    assert tpost.full_rhat["beta"].shape == (G, P)
    assert sum(v.numel() for v in tpost.full_rhat.values()) == G * P + 2 * P
    assert tpost.worst_rhat() < 1.05
    assert tpost.draws["mu"].shape == (C, 400, P)
