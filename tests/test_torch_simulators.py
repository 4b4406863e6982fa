"""The joint densities and the prior and data simulators of the port's
hierarchical logistic (padded and ragged data) and nested Poisson models,
both tau priors each, and of the conjugate normal model: what the
calibration tiers (Geweke, SBC) draw from.

- joint_logdensity against the reference's on the same numpy data and
  state (rtol 1e-4: float32 sums over every observation);
- prior_sample's moments against their closed forms (mu's mean and
  variance, E tau, the standardised group effects (beta - mu) / tau)
  within 5 standard errors at 200k draws;
- sample_data: y in {0, 1} (logistic) or non-negative integers (Poisson),
  zero where masked, and the mean over replicates against sigmoid(eta) or
  exp(eta) within 5 standard errors.

The seeds are this file's, fixed once.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc.data import NestedData as JNestedData
from nestmc.data import NestedData3 as JNestedData3
from nestmc.data import RaggedData as JRaggedData
from nestmc.models import make_hier_logistic as j_make_logistic
from nestmc.models import make_nested_poisson as j_make_poisson
from nestmc_torch.data import from_numpy, from_numpy3, from_numpy_ragged
from nestmc_torch.models import (
    make_hier_logistic,
    make_hier_normal_known_scales,
    make_nested_poisson,
    synth_hier_normal,
)
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401

G, N, P = 5, 7, 3
SPG = 3
S = G * SPG
C = 6
REPS = 200_000
PRIORS = ("halfnormal", "invgamma")


def _np(a):
    return np.array(a, np.float32)


def _logistic_numpy(seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((G, N, P)).astype(np.float32)
    x[:, :, 0] = 1.0
    mask = np.ones((G, N), np.float32)
    mask[0, N - 3:] = 0.0
    mask[3, N - 1:] = 0.0
    y = (r.random((G, N)) < 0.4).astype(np.float32) * mask
    return x, y, mask


def _logistic_pair(ragged, tau_prior, seed=1):
    """(port model, port data, reference model, reference data)."""
    x, y, mask = _logistic_numpy(seed)
    if ragged:
        keep = mask > 0
        seg = np.repeat(np.arange(G), keep.sum(axis=1))
        tdata = from_numpy_ragged(x[keep], y[keep], seg, G, device="cpu")
        jdata = JRaggedData(y=jnp.asarray(y[keep]),
                            segment_ids=jnp.asarray(seg.astype(np.int32)),
                            num_groups=G, x=jnp.asarray(x[keep]))
    else:
        tdata = from_numpy(x, y, mask, device="cpu")
        jdata = JNestedData(y=jnp.asarray(y), mask=jnp.asarray(mask),
                            sizes=jnp.asarray(mask.sum(1).astype(np.int32)),
                            x=jnp.asarray(x))
    return (make_hier_logistic(tdata, tau_prior=tau_prior), tdata,
            j_make_logistic(jdata, tau_prior=tau_prior), jdata)


def _poisson_pair(tau_prior, seed=2):
    r = np.random.default_rng(seed)
    x = (0.5 * r.standard_normal((S, N, P))).astype(np.float32)
    x[:, :, 0] = 1.0
    mask = np.ones((S, N), np.float32)
    mask[1, N - 2:] = 0.0
    y = r.poisson(1.5, (S, N)).astype(np.float32) * mask
    sg = np.repeat(np.arange(G), SPG)
    tdata = from_numpy3(x, y, mask, sg, G, device="cpu")
    jdata = JNestedData3(y=jnp.asarray(y), mask=jnp.asarray(mask),
                         subject_group=jnp.asarray(sg.astype(np.int32)),
                         num_groups=G, x=jnp.asarray(x))
    return (make_nested_poisson(tdata, tau_prior=tau_prior), tdata,
            j_make_poisson(jdata, tau_prior=tau_prior), jdata)


def _random_state(model, seed):
    r = np.random.default_rng(seed)
    st = {}
    for b in model.blocks:
        loc = -0.8 if b.name.startswith("log_tau") else 0.0
        st[b.name] = _np(loc + 0.4 * r.standard_normal((C,) + b.shape))
    return st


def _check_joint(tm, td, jm, jd, seed):
    st = _random_state(tm, seed)
    got = tm.joint_logdensity({k: torch.from_numpy(v) for k, v in st.items()},
                              td)
    want = jm.joint_logdensity({k: jnp.asarray(v) for k, v in st.items()}, jd)
    assert got.shape == (C,)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("tau_prior", PRIORS)
@pytest.mark.parametrize("ragged", [False, True])
def test_logistic_joint_matches_the_reference(ragged, tau_prior):
    _check_joint(*_logistic_pair(ragged, tau_prior), seed=3)


@pytest.mark.parametrize("tau_prior", PRIORS)
def test_poisson_joint_matches_the_reference(tau_prior):
    _check_joint(*_poisson_pair(tau_prior), seed=4)


def _tau_moments(tau_prior, a, b, s):
    """(E tau, sd tau) of the prior: tau ~ |N(0, s^2)|, or tau^2 ~
    InvGamma(a, b) (E tau = sqrt(b) Gamma(a - 1/2) / Gamma(a))."""
    if tau_prior == "halfnormal":
        m = s * math.sqrt(2.0 / math.pi)
        return m, math.sqrt(s * s - m * m)
    m = math.sqrt(b) * math.exp(math.lgamma(a - 0.5) - math.lgamma(a))
    return m, math.sqrt(b / (a - 1.0) - m * m)


def _check_moments(pairs):
    """pairs: (got, want, sd of one draw) for REPS draws."""
    for got, want, sd in pairs:
        assert abs(got - want) < 5.0 * sd / math.sqrt(REPS), (got, want, sd)


def _effect_moments(beta, mean, tau):
    """The standardised effects (beta - mean) / tau: mean 0, variance 1."""
    z = ((beta.double() - mean.double()) / tau.double()).reshape(-1)
    n_per = z.numel() / REPS
    return [(float(z.mean()), 0.0, 1.0 / math.sqrt(n_per)),
            (float((z * z).mean()), 1.0, math.sqrt(2.0 / n_per))]


@pytest.mark.parametrize("tau_prior", PRIORS)
def test_logistic_prior_sample_moments(tau_prior):
    tm, td, _, _ = _logistic_pair(False, tau_prior)
    d = tm.prior_sample(SweepRNG(5, "cpu"), td, REPS)
    assert d["beta"].shape == (REPS, G, P)
    mu = d["mu"][:, 0].double()
    tau = torch.exp(d["log_tau"]).double()
    e_tau, sd_tau = _tau_moments(tau_prior, 2.0, 0.5, 2.0)
    _check_moments([
        (float(mu.mean()), 0.0, 5.0),
        (float((mu * mu).mean()), 25.0, 25.0 * math.sqrt(2.0)),
        (float(tau[:, 1].mean()), e_tau, sd_tau),
        (float(d["beta"][:, :, 2].double().mean()), 0.0,
         math.sqrt(25.0 + e_tau**2 + sd_tau**2)),
        *_effect_moments(d["beta"], d["mu"][:, None, :], tau[:, None, :]),
    ])


@pytest.mark.parametrize("tau_prior", PRIORS)
def test_poisson_prior_sample_moments(tau_prior):
    tm, td, _, _ = _poisson_pair(tau_prior)
    d = tm.prior_sample(SweepRNG(6, "cpu"), td, REPS)
    assert d["beta_s"].shape == (REPS, S, P)
    mu = d["mu"][:, 2].double()
    tau_g = torch.exp(d["log_tau_g"]).double()
    tau_s = torch.exp(d["log_tau_s"]).double()
    e_tau, sd_tau = _tau_moments(tau_prior, 2.0, 0.25, 1.0)
    _check_moments([
        (float(mu.mean()), 0.0, 2.0),
        (float((mu * mu).mean()), 4.0, 4.0 * math.sqrt(2.0)),
        (float(tau_g[:, 0].mean()), e_tau, sd_tau),
        (float(tau_s[:, 1].mean()), e_tau, sd_tau),
        *_effect_moments(d["beta_g"], d["mu"][:, None, :],
                         tau_g[:, None, :]),
        *_effect_moments(d["beta_s"], td.to_subjects(d["beta_g"]),
                         tau_s[:, None, :]),
    ])


def _replicates(model, data, state, k, seed):
    rng = SweepRNG(seed, "cpu")
    return [model.sample_data(rng, state, data) for _ in range(k)]


@pytest.mark.parametrize("ragged", [False, True])
def test_logistic_sample_data(ragged):
    tm, td, _, _ = _logistic_pair(ragged, "invgamma")
    state = tm.prior_sample(SweepRNG(7, "cpu"), td, 2)
    beta = state["beta"][0]
    reps = _replicates(tm, td, state, 4000, 8)
    ys = torch.stack([d.y for d in reps])
    assert type(reps[0]) is type(td)
    assert bool(((ys == 0) | (ys == 1)).all())
    if ragged:
        eta = (beta.index_select(0, td.segment_ids) * td.x).sum(-1)
        torch.testing.assert_close(reps[0].offsets, td.offsets)
    else:
        eta = torch.einsum("gnp,gp->gn", td.x, beta)
        assert bool((ys[:, td.mask == 0] == 0).all())
    prob = torch.sigmoid(eta.double())
    keep = td.mask > 0 if not ragged else torch.ones_like(prob, dtype=bool)
    resid = (ys.double().mean(0) - prob)[keep]
    se = torch.sqrt(prob * (1 - prob) / len(reps))[keep]
    assert float((resid / se).abs().max()) < 5.0
    if not ragged:
        # the simulated data feed the model's own passes
        assert torch.isfinite(tm.joint_logdensity(
            {k: v[:1] for k, v in state.items()}, reps[0])).all()


def test_poisson_sample_data():
    tm, td, _, _ = _poisson_pair("invgamma")
    state = tm.prior_sample(SweepRNG(9, "cpu"), td, 2)
    reps = _replicates(tm, td, state, 4000, 10)
    ys = torch.stack([d.y for d in reps])
    assert bool((ys >= 0).all()) and bool((ys == ys.round()).all())
    assert bool((ys[:, td.mask == 0] == 0).all())
    rate = torch.exp(torch.einsum("snp,sp->sn", td.x,
                                  state["beta_s"][0]).double())
    keep = td.mask > 0
    z = (ys.double().mean(0) - rate) / torch.sqrt(rate / len(reps))
    assert float(z[keep].abs().max()) < 5.0
    assert torch.isfinite(tm.joint_logdensity(
        {k: v[:1] for k, v in state.items()}, reps[0])).all()


def test_conjugate_simulators():
    """mu ~ N(m0, s0^2), theta | mu ~ N(mu, tau^2); y | theta ~ N(theta,
    sigma^2) given chain 0's theta."""
    data = synth_hier_normal(3, G=G, n=N, device="cpu")
    model = make_hier_normal_known_scales(data, sigma=0.7, tau=1.3, m0=0.5,
                                          s0=2.0)
    d = model.prior_sample(SweepRNG(11, "cpu"), data, REPS)
    mu = d["mu"].double()
    _check_moments([
        (float(mu.mean()), 0.5, 2.0),
        (float(((mu - 0.5) ** 2).mean()), 4.0, 4.0 * math.sqrt(2.0)),
        *_effect_moments(d["theta"], mu[:, None], torch.tensor(1.3)),
    ])
    one = {k: v[:1] for k, v in d.items()}
    reps = _replicates(model, data, one, 2000, 12)
    resid = (torch.stack([r.y for r in reps]).double()
             - one["theta"][0][:, None].double()) / 0.7
    assert abs(float(resid.mean())) < 5.0 / math.sqrt(resid.numel())
    assert abs(float(resid.var()) - 1.0) < 5.0 * math.sqrt(
        2.0 / resid.numel())
