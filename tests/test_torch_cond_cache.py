"""The carried-likelihood split must not change the Markov chain (twin of
tests/test_cond_cache.py).

Same model, same seed, with and without the cond_cached split of the beta
block (RW-MH), or the cond_cached_grad split (MALA): the accept decisions
compare the same quantities, so the trajectories agree to float
reassociation (rtol = atol = 2e-4 on every draw, 1e-3 on acceptance) over
50 warmup sweeps and 80 draws; an MH-logic fault would part the chains
within a few sweeps. G=24, n=16, p=3, 8 chains, seed 12, as the
reference. The port runs a block's fused step whenever the model offers
one, so both runs drop the fused tables: what is compared is the plain
update with and without the carried self part. Under MALA both also drop
the interweaving move, whose proposal is Langevin only when a gradient
cache is live (kernels/gibbs.grad_cache_live): with it the two runs would
differ by design.
"""

import dataclasses

import numpy as np
import pytest

from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
from nestmc_torch.models import make_hier_logistic, synth_logistic
from tests.test_torch_calibration import one_thread  # noqa: F401

SPLIT = {"rwmh": "cond_cached", "mala": "cond_cached_grad"}


@pytest.mark.parametrize("algorithm", ["rwmh", "mala"])
def test_cache_matches_uncached_trajectories(algorithm):
    data, _ = synth_logistic(31, G=24, n=16, p=3, device="cpu")
    model = make_hier_logistic(data)
    cached_model = dataclasses.replace(model, fused_updates={},
                                       fused_updates_mala={})
    if algorithm == "mala":
        cached_model = dataclasses.replace(cached_model, joint_moves={})
    assert "beta" in getattr(cached_model, SPLIT[algorithm])
    plain_model = dataclasses.replace(cached_model, **{SPLIT[algorithm]: {}})

    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(chains=8, warmup=50, draws=80, seed=12,
                      log_every_segment=False),
    )
    a = sample(cached_model, data, cfg)
    b = sample(plain_model, data, cfg)
    for k in a.draws:
        np.testing.assert_allclose(a.draws[k].numpy(), b.draws[k].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    for k in a.accept_rates:
        np.testing.assert_allclose(a.accept_rates[k].numpy(),
                                   b.accept_rates[k].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
