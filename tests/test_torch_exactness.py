"""The port's sampler moments against a closed-form posterior: the twin of
tests/test_exactness.py.

The hierarchical normal model with known scales (nestmc_torch.models
.conjugate) has an exact Gaussian posterior. The port's run (RW-MH on
both blocks, plain PyTorch on the CPU) must converge (R-hat < 1.02) and
its posterior means and variances of mu and of every theta_j must land
within 5 x MCSE of the closed form, the reference's z and schedule. The
port's closed form is also held against nestmc's on the same numpy data
(1e-12). The seeds are this file's, fixed once.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nestmc.data import NestedData as JNestedData
from nestmc.models import analytic_hier_normal_posterior as j_analytic
from nestmc_torch import RunConfig, SamplerConfig, sample
from nestmc_torch.models import (
    analytic_hier_normal_posterior,
    make_hier_normal_known_scales,
    synth_hier_normal,
)
from tests.test_torch_calibration import one_thread  # noqa: F401

SIGMA, TAU, M0, S0 = 1.0, 1.5, 0.0, 3.0


@pytest.fixture(scope="module")
def run():
    data = synth_hier_normal(11, G=15, n=8, sigma=SIGMA, tau=TAU, m0=M0,
                             s0=S0, device="cpu")
    model = make_hier_normal_known_scales(data, sigma=SIGMA, tau=TAU, m0=M0,
                                          s0=S0)
    cfg = SamplerConfig(run=RunConfig(
        chains=32, warmup=1500, draws=2500, seed=2, log_every_segment=False,
    ))
    post = sample(model, data, cfg)
    return post, analytic_hier_normal_posterior(data, SIGMA, TAU, M0, S0)


def test_analytic_posterior_matches_the_reference():
    r = np.random.default_rng(4)
    y = r.normal(1.0, 2.0, (6, 5)).astype(np.float32)
    mask = (r.random((6, 5)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    data = synth_hier_normal(0, G=6, n=5, device="cpu")
    data = type(data)(y=data.y.new_tensor(y), mask=data.mask.new_tensor(mask),
                      sizes=data.sizes, x=data.x)
    jdata = JNestedData(y=jnp.asarray(y), mask=jnp.asarray(mask),
                        sizes=jnp.asarray(mask.sum(1).astype(np.int32)))
    got = analytic_hier_normal_posterior(data, 1.3, 0.7, 0.5, 2.0)
    want = j_analytic(jdata, 1.3, 0.7, 0.5, 2.0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_converged(run):
    post, _ = run
    assert post.worst_rhat() < 1.02


def test_mu_mean_exact(run):
    post, truth = run
    d = post.diagnostics()["mu"]
    mcse = float(d["mcse_mean"])
    err = abs(float(d["mean"]) - truth["mu_mean"])
    print(f"exactness mu mean: |err| / mcse {err / mcse:.3f}")
    assert err < 5 * mcse, f"mu mean err {err} vs 5*mcse {5 * mcse}"


def test_mu_var_exact(run):
    post, truth = run
    v = float(post.var("mu"))
    ess = float(post.diagnostics()["mu"]["ess_bulk"])
    # the variance of a variance estimate is about 2 var^2 / ess
    tol = 5 * truth["mu_var"] * np.sqrt(2.0 / ess)
    assert abs(v - truth["mu_var"]) < tol


def test_theta_means_exact(run):
    post, truth = run
    d = post.diagnostics()["theta"]
    err = np.abs(d["mean"].numpy() - truth["theta_mean"])
    tol = 5 * d["mcse_mean"].numpy()
    worst = float((5 * err / tol).max())
    print(f"exactness theta means: max |err| / mcse {worst:.3f}")
    assert np.all(err < tol), f"max err {err.max()}, tol {tol.min()}"


def test_theta_vars_exact(run):
    post, truth = run
    v = post.var("theta").numpy()
    ess = post.diagnostics()["theta"]["ess_bulk"].numpy()
    tol = 5 * truth["theta_var"] * np.sqrt(2.0 / ess)
    assert np.all(np.abs(v - truth["theta_var"]) < tol)
