"""The port's log densities (nestmc_torch/distributions.py and
transforms.py).

Twins of the 18 tests of tests/test_distributions.py: every log density
against scipy.stats on the same float32 inputs, at the reference's
tolerances, and the bijectors' round trip and numerical Jacobian. Then
each of the 18 port functions against nestmc.distributions on float32
inputs from a seeded numpy generator, with float and tensor parameters:
rtol = atol = 1e-5, or 1e-4 where lgamma enters (student_t, the Poisson
and binomial pmfs, gamma, invgamma and beta: torch's and XLA's lgamma
differ in the last bits of float32). The logit pmfs stay finite and
exact at |eta| from 80 to 1000; torch's softplus (threshold 20) agrees
with jax.nn.softplus to float32 rounding.
"""

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax.numpy as jnp

from nestmc import distributions as jd
from nestmc_torch import distributions as d

RNG = np.random.default_rng(0)
X = RNG.normal(size=50).astype(np.float32)
POS = np.abs(RNG.normal(size=50)).astype(np.float32) + 0.1
P01 = RNG.uniform(0.05, 0.95, size=50).astype(np.float32)
COUNTS = RNG.poisson(3.0, size=50).astype(np.float32)
BITS = RNG.integers(0, 2, size=50).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def check(ours, theirs, rtol=2e-5, atol=2e-5):
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=rtol, atol=atol)


def test_normal():
    check(d.logpdf_normal(T(X), 0.5, 2.0), st.norm.logpdf(X, 0.5, 2.0))


def test_normal_prec():
    check(d.logpdf_normal_prec(T(X), 0.5, 4.0), st.norm.logpdf(X, 0.5, 0.5))


def test_halfnormal():
    check(d.logpdf_halfnormal(T(POS), 1.7), st.halfnorm.logpdf(POS, 0, 1.7))


def test_halfcauchy():
    check(d.logpdf_halfcauchy(T(POS), 2.5),
          st.halfcauchy.logpdf(POS, 0, 2.5))


def test_cauchy():
    check(d.logpdf_cauchy(T(X), 0.3, 1.2), st.cauchy.logpdf(X, 0.3, 1.2))


def test_student_t():
    check(d.logpdf_student_t(T(X), 4.0, 0.3, 1.2),
          st.t.logpdf(X, 4, 0.3, 1.2))


def test_bernoulli_logit():
    eta = X * 3
    p = 1 / (1 + np.exp(-eta))
    check(d.logpmf_bernoulli_logit(T(BITS), T(eta)),
          st.bernoulli.logpmf(BITS.astype(int), p), rtol=1e-4, atol=1e-5)


def test_poisson_log():
    eta = X.astype(np.float64) * 0.5
    check(d.logpmf_poisson_log(T(COUNTS), T(eta)),
          st.poisson.logpmf(COUNTS.astype(int), np.exp(eta)),
          rtol=1e-4, atol=1e-4)


def test_binomial_logit():
    y = RNG.integers(0, 11, size=50).astype(np.float32)
    p = 1 / (1 + np.exp(-X))
    check(d.logpmf_binomial_logit(T(y), 10.0, T(X)),
          st.binom.logpmf(y.astype(int), 10, p), rtol=1e-4, atol=1e-4)


def test_gamma():
    check(d.logpdf_gamma(T(POS), 2.5, 1.5),
          st.gamma.logpdf(POS, 2.5, scale=1 / 1.5), rtol=1e-4, atol=1e-4)


def test_invgamma():
    check(d.logpdf_invgamma(T(POS), 3.0, 2.0),
          st.invgamma.logpdf(POS, 3.0, scale=2.0), rtol=1e-4, atol=1e-4)


def test_exponential():
    check(d.logpdf_exponential(T(POS), 2.0), st.expon.logpdf(POS, scale=0.5))


def test_lognormal():
    check(d.logpdf_lognormal(T(POS), 0.2, 0.8),
          st.lognorm.logpdf(POS, 0.8, scale=np.exp(0.2)),
          rtol=1e-4, atol=1e-4)


def test_beta():
    check(d.logpdf_beta(T(P01), 2.0, 3.0), st.beta.logpdf(P01, 2.0, 3.0),
          rtol=1e-4, atol=1e-4)


def test_uniform():
    check(d.logpdf_uniform(T(P01), 0.0, 2.0), st.uniform.logpdf(P01, 0, 2))
    assert np.isneginf(float(d.logpdf_uniform(torch.tensor(3.0), 0.0, 2.0)))


def test_mvn_diag():
    x = RNG.normal(size=(7, 3)).astype(np.float32)
    loc = np.array([0.1, -0.2, 0.3], np.float32)
    sd = np.array([1.0, 2.0, 0.5], np.float32)
    check(d.logpdf_mvn_diag(T(x), T(loc), T(sd)),
          st.multivariate_normal.logpdf(x, loc, np.diag(sd**2)),
          rtol=1e-4, atol=1e-4)


def test_mvn_chol():
    a = RNG.normal(size=(3, 3))
    cov = a @ a.T + 3 * np.eye(3)
    chol = np.linalg.cholesky(cov).astype(np.float32)
    x = RNG.normal(size=(7, 3)).astype(np.float32)
    loc = np.zeros(3, np.float32)
    check(d.logpdf_mvn_chol(T(x), T(loc), T(chol)),
          st.multivariate_normal.logpdf(x, loc, cov), rtol=1e-4, atol=1e-4)


def test_transforms_roundtrip_and_jacobian():
    from nestmc_torch import transforms as tr

    for name in ("identity", "log", "logit", "softplus"):
        t = tr.get(name)
        x = T(np.linspace(-3, 3, 21))
        np.testing.assert_allclose(t.inverse(t.forward(x)).numpy(),
                                   x.numpy(), rtol=1e-4, atol=1e-4)
        eps = 1e-3
        num = (t.forward(x + eps) - t.forward(x - eps)).numpy() / (2 * eps)
        np.testing.assert_allclose(t.log_jac(x).numpy(),
                                   np.log(np.abs(num) + 1e-30),
                                   rtol=5e-3, atol=5e-3)


# ---- parity with nestmc.distributions ----

LGAMMA = dict(rtol=1e-4, atol=1e-4)
PLAIN = dict(rtol=1e-5, atol=1e-5)


def _parity_cases():
    r = np.random.default_rng(7)

    def f(*shape, lo=None, hi=None, pos=False):
        if lo is not None:
            a = r.uniform(lo, hi, size=shape)
        else:
            a = r.normal(size=shape)
        return (np.abs(a) + 0.2 if pos else a).astype(np.float32)

    x, xp, x01 = f(4, 9), f(4, 9, pos=True), f(4, 9, lo=0.02, hi=0.98)
    y01 = r.integers(0, 2, (4, 9)).astype(np.float32)
    cnt = r.poisson(2.5, (4, 9)).astype(np.float32)
    trials = r.integers(0, 12, (4, 9)).astype(np.float32)
    succ = np.floor(trials * r.uniform(size=(4, 9))).astype(np.float32)
    row = f(9, pos=True)
    chol = np.tril(f(4, 3, 3)) + 2.0 * np.eye(3, dtype=np.float32)
    return {
        "logpdf_normal": ((x, f(9), row), PLAIN),
        "logpdf_normal_prec": ((x, 0.3, row), PLAIN),
        "logpdf_halfnormal": ((xp, row), PLAIN),
        "logpdf_halfcauchy": ((xp, 2.5), PLAIN),
        "logpdf_cauchy": ((x, 0.3, row), PLAIN),
        "logpdf_student_t": ((x, 3.5, f(9), row), LGAMMA),
        "logpmf_bernoulli_logit": ((y01, 3.0 * x), PLAIN),
        "logpmf_poisson_log": ((cnt, 0.5 * x), LGAMMA),
        "logpmf_binomial_logit": ((succ, trials, x), LGAMMA),
        "logpdf_gamma": ((xp, row + 1.0, 1.5), LGAMMA),
        "logpdf_invgamma": ((xp, 3.0, row), LGAMMA),
        "logpdf_exponential": ((xp, row), PLAIN),
        "logpdf_lognormal": ((xp, 0.2, row), PLAIN),
        "logpdf_beta": ((x01, row + 0.5, 2.0), LGAMMA),
        "log_scale_guard": ((14.0 * x,), PLAIN),
        "logpdf_uniform": ((x, -0.5, row), PLAIN),
        "logpdf_mvn_diag": ((f(4, 3), f(3), f(3, pos=True)), PLAIN),
        "logpdf_mvn_chol": ((f(4, 3), f(3), chol), PLAIN),
    }


CASES = _parity_cases()


def test_parity_covers_every_function():
    names = {n for n in dir(jd) if n.startswith(("logp", "log_scale"))}
    assert names == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    args, tol = CASES[name]
    ours = getattr(d, name)(*[T(a) if isinstance(a, np.ndarray) else a
                              for a in args])
    ref = np.asarray(getattr(jd, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for a in args]))
    assert ours.dtype == torch.float32
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(ours.numpy()),
                                  np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours.numpy()[fin], ref[fin], **tol)


@pytest.mark.parametrize("name", ["logpmf_bernoulli_logit",
                                  "logpmf_binomial_logit"])
def test_logit_pmfs_finite_at_large_eta(name):
    """Finite at |eta| = 80 .. 1000, equal to the float64 value
    y eta - softplus(eta) (one trial: the binomial coefficient is 0) to
    float32 rounding, and to the reference's within one float32 ulp of
    |eta| (XLA's fused softplus rounds differently there)."""
    eta = np.array([-1000.0, -100.0, -80.0, 80.0, 100.0, 1000.0], np.float32)
    y = np.array([1.0, 0.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    args = (y, eta) if name == "logpmf_bernoulli_logit" else (y, 1.0, eta)
    ours = getattr(d, name)(*[T(a) if isinstance(a, np.ndarray) else a
                              for a in args]).numpy()
    ref = np.asarray(getattr(jd, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for a in args]))
    e64 = eta.astype(np.float64)
    exact = y * e64 - np.logaddexp(0.0, e64)
    assert np.all(np.isfinite(ours)), ours
    np.testing.assert_allclose(ours, exact, rtol=1e-7, atol=1e-30)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=float(np.spacing(np.float32(1000.0))))


def test_softplus_matches_jax_softplus():
    """torch's softplus switches to x above threshold=20; jax.nn.softplus
    never does. They agree to float32 rounding everywhere."""
    import jax

    x = np.linspace(-120.0, 120.0, 4001).astype(np.float32)
    ours = torch.nn.functional.softplus(T(x)).numpy()
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=2e-7, atol=1e-30)
