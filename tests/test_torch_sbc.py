"""Simulation-based calibration through the port's engine (twin of
tests/test_sbc.py; Talts et al. 2018).

For each of C = 512 replicas (the chains, each with its own data set in
the chain-batched {"y": (C, G, N)} dict): draw the parameters from the
prior, simulate data, run the full engine (warmup with adaptation, the
freeze, thinned sampling, collection) and rank the true value among the
L = 127 retained draws. A sampler that targets the posterior gives ranks
uniform on {0..L}: a chi-square test on 8 bins per parameter, failing at
p < 1e-3. The companion checks that the posterior contracts (uniform
ranks alone cannot tell the posterior from the prior). The reference's
sizes, threshold and ``slow`` marker; the model is the port's twin of
tests/calibration_model.py (tests/test_torch_calibration.py).
"""

import numpy as np
import pytest
import scipy.stats as st
import torch

from nestmc_torch.config import RunConfig, SamplerConfig
from nestmc_torch.engine import sample
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import (  # noqa: F401
    make_calibration_model,
    one_thread,
    sample_y,
)

G, N = 4, 3
C = 512       # replicas
L = 127       # retained draws per replica (ranks in {0..127})
THIN = 4


def _truth_and_data(seed):
    model = make_calibration_model(G, N)
    truth = model.prior_sample(SweepRNG(seed, "cpu"), None, C)
    data = {"y": sample_y(SweepRNG(seed + 1000, "cpu"), truth["theta"], N)}
    return model, truth, data


@pytest.mark.slow
def test_sbc_ranks_uniform():
    model, truth, data = _truth_and_data(42)
    cfg = SamplerConfig(run=RunConfig(
        chains=C, warmup=500, draws=L, thin=THIN, seed=7,
        log_every_segment=False))
    post = sample(model, data, cfg)

    failures = {}
    for name, tr in (("mu", truth["mu"]), ("log_tau", truth["log_tau"]),
                     ("theta", truth["theta"][:, 0])):
        draws = post.draws[name]
        if draws.ndim == 3:
            draws = draws[:, :, 0]
        ranks = torch.sum(draws < tr[:, None], dim=1).numpy()
        bins = 8
        width = (L + 1) / bins
        counts = np.bincount((ranks / width).astype(int),
                             minlength=bins)[:bins]
        expected = C / bins
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        pval = st.chi2.sf(chi2, bins - 1)
        if pval < 1e-3:
            failures[name] = (chi2, pval, counts.tolist())
    assert not failures, f"SBC rank uniformity failed: {failures}"


@pytest.mark.slow
def test_sbc_sampler_actually_conditions_on_data():
    """Per-replica posterior sd of theta well below the prior sd."""
    model, truth, data = _truth_and_data(43)
    cfg = SamplerConfig(run=RunConfig(
        chains=C, warmup=300, draws=L, thin=THIN, seed=8,
        log_every_segment=False))
    post = sample(model, data, cfg)
    post_sd = float(post.draws["theta"][:, :, 0].std(dim=1).mean())
    prior_sd = float(truth["theta"][:, 0].std())
    assert post_sd < 0.6 * prior_sd, (post_sd, prior_sd)
