"""The port's eight-schools model (BASELINE config 1): the twin of
tests/test_eight_schools.py, plus its parts against the reference.

The port's run (non-centred, RW-MH on every block, plain PyTorch on the
CPU, the reference's schedule) must converge (R-hat < 1.01) and its
posterior mu (mean and variance), tau and derived theta means must land
within 6 standard errors of the reference's dense float64 quadrature,
imported from tests/test_eight_schools.py so that the yardstick is
literally the reference's. Both parameterisations' conditionals and joint,
the derived theta, the half-Cauchy and Cauchy log densities and the prior
and data simulators are held against nestmc on shared inputs (1e-5), and
the engine's collection of derived quantities is checked for
collect=None and collect={"theta": None}. The seeds are this file's, fixed
once.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc import distributions as jdist
from nestmc.models import make_eight_schools as j_make
from nestmc_torch import RunConfig, SamplerConfig, sample
from nestmc_torch import distributions as tdist
from nestmc_torch.diagnostics import ess
from nestmc_torch.models import make_eight_schools
from nestmc_torch.rng import SweepRNG
from tests.test_eight_schools import quadrature_reference
from tests.test_torch_calibration import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
C = 6


def _np(a):
    return np.array(a, np.float32)


@pytest.fixture(scope="module")
def run():
    model, data = make_eight_schools(device="cpu")
    cfg = SamplerConfig(run=RunConfig(
        chains=64, warmup=2000, draws=4000, seed=8, log_every_segment=False,
    ))
    return sample(model, data, cfg), quadrature_reference()


def test_converged(run):
    post, _ = run
    assert post.worst_rhat() < 1.01


def test_mu_matches_quadrature(run):
    post, ref = run
    d = post.diagnostics()["mu"]
    err = abs(float(d["mean"]) - ref["mu_mean"])
    print(f"eight schools mu: |err| / mcse {err / float(d['mcse_mean']):.3f}")
    assert err < 6 * float(d["mcse_mean"]), (
        f"mu {float(d['mean']):.3f} vs quadrature {ref['mu_mean']:.3f}"
    )
    v = float(post.var("mu"))
    e = float(d["ess_bulk"])
    assert abs(v - ref["mu_var"]) < 6 * ref["mu_var"] * np.sqrt(2 / e)


def test_tau_matches_quadrature(run):
    post, ref = run
    tau = torch.exp(post.draws["log_tau"])
    se = float(tau.std()) / math.sqrt(float(ess(tau)))
    err = abs(float(tau.mean()) - ref["tau_mean"])
    print(f"eight schools tau: |err| / se {err / se:.3f}")
    assert err < 6 * se, (
        f"tau {float(tau.mean()):.3f} vs quadrature {ref['tau_mean']:.3f}"
    )


def test_theta_matches_quadrature(run):
    post, ref = run
    d = post.diagnostics()["theta"]
    err = np.abs(d["mean"].numpy() - ref["theta_mean"])
    tol = 6 * d["mcse_mean"].numpy()
    print(f"eight schools theta: max |err| / mcse "
          f"{float((6 * err / tol).max()):.3f}")
    assert np.all(err < tol), f"theta err {err} vs tol {tol}"


def _state(centered, seed=1):
    r = np.random.default_rng(seed)
    st = {"mu": r.normal(5.0, 4.0, C), "log_tau": r.normal(1.0, 0.8, C)}
    st["theta" if centered else "z"] = r.normal(0.0, 3.0 if centered else 1.0,
                                                (C, 8))
    return {k: _np(v) for k, v in st.items()}


@pytest.mark.parametrize("centered", [False, True])
def test_cond_and_joint_match_the_reference(centered):
    jm, jd = j_make(centered=centered)
    tm, td = make_eight_schools(centered=centered, device="cpu")
    st = _state(centered)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    r = np.random.default_rng(2)
    for b in tm.blocks:
        value = _np(st[b.name] + 0.5 * r.standard_normal(st[b.name].shape))
        got = tm.cond_logdensity(b.name, torch.from_numpy(value), tst, td)
        want = jm.cond_logdensity(b.name, jnp.asarray(value), jst, jd)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL,
                                   err_msg=b.name)
    np.testing.assert_allclose(tm.joint_logdensity(tst, td).numpy(),
                               _np(jm.joint_logdensity(jst, jd)), **TOL)
    assert [b.name for b in tm.blocks] == [b.name for b in jm.blocks]
    assert [(b.units, b.init_scale) for b in tm.blocks] == [
        (b.units, b.init_scale) for b in jm.blocks]
    if not centered:
        np.testing.assert_allclose(tm.derived["theta"](tst).numpy(),
                                   _np(jm.derived["theta"](jst)), **TOL)


def test_cauchy_log_densities_match_the_reference():
    x = np.abs(np.random.default_rng(3).standard_cauchy(50)).astype(
        np.float32)
    for scale in (1.0, 5.0):
        np.testing.assert_allclose(
            tdist.logpdf_halfcauchy(torch.from_numpy(x), scale).numpy(),
            _np(jdist.logpdf_halfcauchy(jnp.asarray(x), scale)), **TOL)
        np.testing.assert_allclose(
            tdist.logpdf_cauchy(torch.from_numpy(x - 2.0), 0.5, scale).numpy(),
            _np(jdist.logpdf_cauchy(jnp.asarray(x - 2.0), 0.5, scale)),
            **TOL)


@pytest.mark.parametrize("centered", [False, True])
def test_prior_sample_has_the_prior_moments(centered):
    """mu ~ N(0, 10^2), tau ~ HalfCauchy(5) (its median is the scale),
    theta | mu, tau ~ N(mu, tau^2) (non-centred: z ~ N(0, 1)), within 5
    standard errors at 200k draws; sample_data gives y (8, 1) with
    y - theta_0 ~ N(0, sigma^2)."""
    model, data = make_eight_schools(centered=centered, device="cpu")
    n = 200_000
    rng = SweepRNG(4, "cpu")
    d = model.prior_sample(rng, data, n)
    mu = d["mu"].double()
    tau = torch.exp(d["log_tau"]).double()
    theta = d["theta"] if centered else model.derived["theta"](d)
    z = ((theta.double() - mu[:, None]) / tau[:, None]).reshape(-1)
    below = float((tau < 5.0).double().mean())
    for got, want, sd in (
        (float(mu.mean()), 0.0, 10.0),
        (float((mu * mu).mean()), 100.0, 100.0 * math.sqrt(2.0)),
        (below, 0.5, 0.5),
        (float(z.mean()), 0.0, 1.0),
        (float((z * z).mean()), 1.0, math.sqrt(2.0)),
    ):
        assert abs(got - want) < 5.0 * sd / math.sqrt(n), (got, want)
    # one chain-0 state, many simulated data sets
    one = {k: v[:1] for k, v in d.items()}
    th0 = (one["theta"] if centered else model.derived["theta"](one))[0]
    ys = torch.stack([model.sample_data(rng, one, data).y[:, 0]
                      for _ in range(4000)])
    resid = (ys - th0) / data.extra["sigma"]
    assert abs(float(resid.mean())) < 5.0 / math.sqrt(resid.numel())
    assert abs(float(resid.var()) - 1.0) < 5.0 * math.sqrt(
        2.0 / resid.numel())


@pytest.mark.parametrize("collect", [None, {"theta": None}])
def test_engine_collects_derived_theta(collect):
    model, data = make_eight_schools(device="cpu")
    cfg = SamplerConfig(run=RunConfig(chains=4, warmup=50, draws=40, seed=5,
                                      collect=collect, full_rhat=True,
                                      log_every_segment=False))
    post = sample(model, data, cfg)
    want = {"theta"} if collect else {"z", "mu", "log_tau", "theta"}
    assert set(post.draws) == want
    assert post.draws["theta"].shape == (4, 40, 8)
    assert set(post.full_rhat) == {"z", "mu", "log_tau"}
    assert "theta" in post.diagnostics()
    if collect is None:
        theta = model.derived["theta"]({
            k: post.draws[k].reshape((-1,) + tuple(post.draws[k].shape[2:]))
            for k in ("z", "mu", "log_tau")})
        torch.testing.assert_close(post.draws["theta"].reshape(-1, 8), theta)
    assert "theta" in post.summary_table()
