"""The port's hier_glm binomial family end to end on the CPU against
nestmc.sample on the same data.

The logistic delegate on reweighted data (its fused Newton step's plain
version): 16 groups x 10 obs with masked rows and varying trials, p = 2,
16 chains, 200 warmup sweeps and 400 draws, invgamma tau, frozen-metric
Newton. The two packages draw different random numbers, so the chains
differ; the posterior means of mu and log tau agree within 4 combined
MCSEs and the mean beta acceptance within 0.05. The Poisson family's twin
and its Geweke tier are in tests/test_torch_hier_glm_slice_poisson.py
(one family a file keeps each file's first JAX compilation under 30 s).
"""

import numpy as np

import nestmc
from nestmc.models.hier_glm import make_hier_glm as j_make
import nestmc_torch
from nestmc_torch.models import make_hier_glm
from tests.test_torch_calibration import one_thread  # noqa: F401
from tests.test_torch_hier_glm import glm_data

RUN = dict(chains=16, warmup=200, draws=400, seed=3,
           collect={"mu": None, "log_tau": None}, log_every_segment=False)


def posterior_means_agree(family):
    """Both packages' posteriors of ``family`` on the same data."""
    jdata, tdata = glm_data(family, seed=5, G=16, n=10, p=2, masked=True)
    kernel = dict(algorithm="newton")
    jpost = nestmc.sample(
        j_make(jdata, family=family, tau_prior="invgamma"), jdata,
        nestmc.SamplerConfig(kernel=nestmc.KernelConfig(**kernel),
                             run=nestmc.RunConfig(**RUN)))
    tpost = nestmc_torch.sample(
        make_hier_glm(tdata, family=family, tau_prior="invgamma"), tdata,
        nestmc_torch.SamplerConfig(
            kernel=nestmc_torch.KernelConfig(**kernel),
            run=nestmc_torch.RunConfig(**RUN)))
    for name in ("mu", "log_tau"):
        jd, td = jpost.diagnostics()[name], tpost.diagnostics()[name]
        jm, tm = np.asarray(jd["mean"]), td["mean"].numpy()
        se = np.sqrt(np.asarray(jd["mcse_mean"]) ** 2
                     + td["mcse_mean"].numpy() ** 2)
        assert np.all(np.abs(jm - tm) < 4 * se), (family, name, jm, tm, se)
    ja = float(np.mean(np.asarray(jpost.accept_rates["beta"])))
    ta = float(tpost.accept_rates["beta"].mean())
    assert abs(ja - ta) < 0.05, (ja, ta)


def test_binomial_posterior_means_agree():
    posterior_means_agree("binomial")
