"""Posterior-predictive simulation of the port (nestmc_torch/predictive.py):
the twins of tests/test_predictive.py's four tests on the CPU, the
p-value against nestmc.predictive_pvalue on the same replicates (1e-6),
and replicates of the hier_glm binomial family in count space."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc import predictive_pvalue as j_pvalue
from nestmc.data import NestedData as JNestedData
from nestmc_torch import (
    RunConfig,
    SamplerConfig,
    posterior_predictive,
    predictive_pvalue,
    sample,
)
from nestmc_torch.models import (
    make_hier_glm,
    make_hier_logistic,
    synth_glm,
    synth_logistic,
)
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def fit():
    data, _ = synth_logistic(4, G=40, n=20, p=3, device="cpu")
    model = make_hier_logistic(data, tau_prior="invgamma")
    post = sample(model, data, SamplerConfig(run=RunConfig(
        chains=8, warmup=400, draws=400, log_every_segment=False,
    )))  # collect=None: full blocks, as the simulator requires
    return model, data, post


def test_replicates_shape_and_calibration(fit):
    model, data, post = fit
    y_rep = posterior_predictive(model, post, data, SweepRNG(1, "cpu"),
                                 num=48)
    assert y_rep.shape == (48,) + tuple(data.y.shape)
    assert bool(torch.isfinite(y_rep).all())
    # well-specified model: the observed mean is typical of replicates
    pval = float(predictive_pvalue(y_rep, data))
    assert 0.02 < pval < 0.98, pval
    # replicates vary across draws (not one frozen parameter)
    assert float(y_rep.mean(dim=(1, 2)).std()) > 0
    # the reference's p-value of the same replicates
    jdata = JNestedData(y=jnp.asarray(data.y.numpy()),
                        mask=jnp.asarray(data.mask.numpy()),
                        sizes=jnp.asarray(data.sizes.numpy()),
                        x=jnp.asarray(data.x.numpy()), extra={})
    want = float(j_pvalue(jnp.asarray(y_rep.numpy()), jdata))
    assert abs(pval - want) < 1e-6, (pval, want)


def test_custom_statistic(fit):
    model, data, post = fit
    y_rep = posterior_predictive(model, post, data, SweepRNG(2, "cpu"),
                                 num=32)

    def frac_ones(y, m):
        return torch.sum(y * m) / torch.sum(m)

    pval = float(predictive_pvalue(y_rep, data, stat=frac_ones))
    assert 0.0 <= pval <= 1.0


def test_partial_collection_of_unread_blocks_ok():
    """Blocks the simulator never reads (mu, log_tau of hier_logistic:
    sample_data reads only beta) may be partially collected; only read
    blocks must be full."""
    data, _ = synth_logistic(5, G=20, n=10, p=2, device="cpu")
    model = make_hier_logistic(data)
    post = sample(model, data, SamplerConfig(run=RunConfig(
        chains=4, warmup=100, draws=100, log_every_segment=False,
        collect={"beta": None, "mu": None, "log_tau": 1},
    )))
    y_rep = posterior_predictive(model, post, data, SweepRNG(3, "cpu"),
                                 num=8)
    assert y_rep.shape == (8,) + tuple(data.y.shape)

    # a partially collected read block raises the informative error
    post2 = sample(model, data, SamplerConfig(run=RunConfig(
        chains=4, warmup=100, draws=100, log_every_segment=False,
        collect={"beta": 4, "mu": None, "log_tau": None},
    )))
    with pytest.raises(ValueError, match="fully collected"):
        posterior_predictive(model, post2, data, SweepRNG(3, "cpu"), num=8)


def test_requires_simulator():
    data, _ = synth_logistic(4, G=8, n=5, p=2, device="cpu")
    model = make_hier_logistic(data)
    broken = dataclasses.replace(model, sample_data=None)

    class _P:  # minimal stand-in
        draws = {"beta": torch.zeros((2, 3, 8, 2))}

    with pytest.raises(ValueError, match="sample_data"):
        posterior_predictive(broken, _P(), data)


def test_binomial_replicates_in_count_space():
    data, _ = synth_glm(6, family="binomial", G=12, n=8, p=2, trials=5,
                        device="cpu")
    model = make_hier_glm(data, family="binomial", tau_prior="invgamma")
    post = sample(model, data, SamplerConfig(run=RunConfig(
        chains=4, warmup=60, draws=60, log_every_segment=False,
        collect={"beta": None, "mu": 1},
    )))
    y_rep = posterior_predictive(model, post, data, num=16)
    y = y_rep.numpy()
    assert y.shape == (16, 12, 8)
    assert (y >= 0).all() and (y <= 5).all()
    np.testing.assert_array_equal(y, np.round(y))
    assert 0.0 <= float(predictive_pvalue(y_rep, data)) <= 1.0
