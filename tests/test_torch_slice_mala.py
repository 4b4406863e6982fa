"""The port's MALA sampler vs nestmc's, end to end on the CPU, on the
same data (test_torch_slice_rw.py: the same for RW-MH).

The two packages draw different random numbers (threefry vs torch), so the
chains differ; the posteriors must agree. G=16 groups x n=20 obs, p=3, 32
chains, 200 warmup sweeps, 400 draws, the half-normal tau prior (an MH
block on log tau), the interweaving move in its grad (Langevin) mode,
adapted scales, streamed all-param R-hat. Posterior means of mu and
log_tau agree within 4 combined MCSEs, and the mean beta acceptance within
0.05.
"""

import numpy as np
import pytest

import jax

import nestmc
from nestmc.models import make_hier_logistic as j_make, synth_logistic
import nestmc_torch
from nestmc_torch.data import from_numpy
from nestmc_torch.models import make_hier_logistic

C, G, N, P = 32, 16, 20, 3
ALGORITHM = "mala"


@pytest.fixture(scope="module")
def posteriors():
    data, _ = synth_logistic(jax.random.key(5), G=G, n=N, p=P)
    kernel = dict(algorithm=ALGORITHM)
    run = dict(chains=C, warmup=200, draws=400, seed=3, full_rhat=True,
               collect={"mu": None, "log_tau": None},
               log_every_segment=False)
    jpost = nestmc.sample(
        j_make(data), data,
        nestmc.SamplerConfig(kernel=nestmc.KernelConfig(**kernel),
                             run=nestmc.RunConfig(**run)),
    )
    tdata = from_numpy(data.x, data.y, data.mask, device="cpu")
    tpost = nestmc_torch.sample(
        make_hier_logistic(tdata), tdata,
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


def test_acceptance_agrees(posteriors):
    jpost, tpost = posteriors
    for k in ("beta", "log_tau", "asis_tau"):
        ja = float(np.mean(np.asarray(jpost.accept_rates[k])))
        ta = float(tpost.accept_rates[k].mean())
        assert abs(ja - ta) < 0.05, (k, ja, ta)
    assert set(tpost.full_rhat) == set(jpost.full_rhat)
    assert tpost.full_rhat["beta"].shape == (G, P)
    assert tpost.draws["mu"].shape == (C, 400, P)
