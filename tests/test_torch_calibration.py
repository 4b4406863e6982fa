"""The port's twins of the reference's test-local calibration models, held
against them, and the two repairs those models need.

Twins (the Geweke tiers tests/test_torch_geweke*.py import them from
here): tests/calibration_model.py's chain-batched hierarchical normal
model (random-walk, Langevin and broken-q interweaving moves), its broken
Jacobian variant and sample_y; tests/test_geweke_newton.py's
Bernoulli-logit model with analytic scalar-unit Newton hooks. Each
conditional, the joint and the Newton hooks match the JAX model's on the
same numpy state and data (rtol 1e-5, atol 1e-5).

Repairs: kernels/newton.newton_update on a block with scalar units (p = 1,
as nestmc/kernels/newton.py runs it), refresh and frozen, against
nestmc's update on replayed noise (1e-5), also through one replayed
make_sweep; and opaque data: init_kernel_state and a sweep with data a
plain {"y": tensor} dict.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig as JKernelConfig
from nestmc.config import RunConfig as JRunConfig
from nestmc.config import SamplerConfig as JSamplerConfig
from nestmc.kernels.gibbs import make_sweep as j_make_sweep
from nestmc.kernels.newton import newton_update as j_newton_update
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.distributions import logpdf_halfnormal, logpdf_normal
from nestmc_torch.engine import sample
from nestmc_torch.kernels.gibbs import make_sweep
from nestmc_torch.kernels.newton import newton_update
from nestmc_torch.kernels.rwmh import accept_prob
from nestmc_torch.kernels.state import init_kernel_state, state_from_numpy
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.rng import ReplayRNG, SweepRNG
from tests import calibration_model as jcal
from tests.test_geweke_newton import (
    make_logistic_calibration_model as j_make_logit,
)

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: these tests run many small ops,
    which one thread runs as fast, and several threads a worker stall
    under the parallel test workers (a Geweke file took 20x longer).
    The other test_torch_* agreement files import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/calibration_model.py
S0, TAU0, SIGMA = 2.0, 1.5, 1.0
# tests/test_geweke_newton.py
S0_LOGIT, TAU0_LOGIT = 1.2, 1.0
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = jnp.finfo(jnp.float32).tiny


def make_calibration_model(G: int, n: int, grad_asis=False,
                           asis_init_scale: float = 0.1) -> ModelSpec:
    """Twin of tests/calibration_model.py::make_calibration_model, data a
    dict {"y": (C, G, n)}. grad_asis: False = the random-walk interweaving
    move; True = its Langevin form with analytic gradients; "broken-q" =
    the Langevin form without the asymmetric-proposal correction."""

    def _lik(state, data):
        return torch.sum(
            logpdf_normal(data["y"], state["theta"][:, :, None], SIGMA),
            dim=-1,
        )                                                  # (C, G)

    def _gprior(state):
        tau = torch.exp(state["log_tau"])[:, None]
        return logpdf_normal(state["theta"], state["mu"][:, None], tau)

    def cond(name, value, state, data):
        state = {**state, name: value}
        if name == "theta":
            return _lik(state, data) + _gprior(state)
        if name == "mu":
            return (torch.sum(_gprior(state), dim=-1)
                    + logpdf_normal(state["mu"], 0.0, S0))
        if name == "log_tau":
            lt = state["log_tau"]
            return (torch.sum(_gprior(state), dim=-1)
                    + logpdf_halfnormal(torch.exp(lt), TAU0) + lt)
        raise KeyError(name)

    def joint(state, data):
        lt = state["log_tau"]
        return (
            torch.sum(_lik(state, data) + _gprior(state), dim=-1)
            + logpdf_normal(state["mu"], 0.0, S0)
            + logpdf_halfnormal(torch.exp(lt), TAU0) + lt
        )

    def prior_sample(rng, data, chains):
        mu = S0 * rng.normal((chains,))
        tau = TAU0 * torch.abs(rng.normal((chains,)))
        theta = mu[:, None] + tau[:, None] * rng.normal((chains, G))
        return {"theta": theta, "mu": mu, "log_tau": torch.log(tau)}

    def _prior_delta(lt, lt_new):
        return (logpdf_halfnormal(torch.exp(lt_new), TAU0) + lt_new
                - logpdf_halfnormal(torch.exp(lt), TAU0) - lt)

    def _finish(rng, position, data, theta_new, lt_new, q_corr):
        theta, lt = position["theta"], position["log_tau"]
        lik_old = torch.sum(_lik(position, data), dim=-1)
        lik_new = torch.sum(_lik({**position, "theta": theta_new}, data),
                            dim=-1)
        log_alpha = lik_new - lik_old + _prior_delta(lt, lt_new) + q_corr
        accept = rng.log_uniform(lt.shape) < log_alpha
        pos_up = {
            "theta": torch.where(accept[:, None], theta_new, theta),
            "log_tau": torch.where(accept, lt_new, lt),
        }
        return pos_up, {}, accept_prob(log_alpha)

    def asis_tau_move(rng, position, cache, scale, data):
        """The random-walk interweaving move: z = (theta - mu)/tau fixed,
        (tau, theta) rescaled jointly. Noise: eps (C,), then log u (C,)."""
        theta, mu, lt = position["theta"], position["mu"], position["log_tau"]
        lt_new = lt + scale[:, 0] * rng.normal(lt.shape)
        ratio = torch.exp(lt_new - lt)[:, None]
        theta_new = mu[:, None] + (theta - mu[:, None]) * ratio
        return _finish(rng, position, data, theta_new, lt_new, 0.0)

    def asis_tau_move_grad(rng, position, cache, scale, data):
        """The Langevin form: lt' = lt + (s^2/2) F'(lt) + s eps on the
        z-fixed target, F' by the chain rule, with the asymmetric-proposal
        correction (dropped for "broken-q")."""
        theta, mu, lt = position["theta"], position["mu"], position["log_tau"]
        s = scale[:, 0]
        s2 = s * s
        eps = rng.normal(lt.shape)
        diff = theta - mu[:, None]

        def _glt(ltv, diffv):
            th = mu[:, None] + diffv
            glik = torch.sum((data["y"] - th[:, :, None]) / SIGMA**2, dim=-1)
            return (torch.sum(glik * diffv, dim=-1)
                    + 1.0 - torch.exp(2.0 * ltv) / TAU0**2)

        g_old = _glt(lt, diff)
        lt_new = lt + 0.5 * s2 * g_old + s * eps
        diff_new = diff * torch.exp(lt_new - lt)[:, None]
        g_new = _glt(lt_new, diff_new)
        fwd = lt_new - lt - 0.5 * s2 * g_old
        rev = lt - lt_new - 0.5 * s2 * g_new
        q_corr = (fwd * fwd - rev * rev) / (2.0 * s2)
        if grad_asis == "broken-q":
            q_corr = torch.zeros_like(q_corr)
        return _finish(rng, position, data, mu[:, None] + diff_new, lt_new,
                       q_corr)

    return ModelSpec(
        name="calibration_hier_normal",
        blocks=(
            Block("theta", (G,), units=G, init_scale=0.5),
            Block("mu", (), init_scale=0.5),
            Block("log_tau", (), init_scale=0.3),
        ),
        init_state=prior_sample,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        joint_moves={
            "asis_tau": asis_tau_move_grad if grad_asis else asis_tau_move
        },
        joint_move_init_scale={"asis_tau": asis_init_scale},
    )


def make_broken_model(G: int, n: int) -> ModelSpec:
    """Twin of tests/calibration_model.py::make_broken_model: the log_tau
    conditional without its Jacobian (the Geweke power check)."""
    good = make_calibration_model(G, n)

    def cond(name, value, state, data):
        out = good.cond_logdensity(name, value, state, data)
        return out - value if name == "log_tau" else out

    return dataclasses.replace(good, cond_logdensity=cond)


def sample_y(rng, theta, n):
    """(C, G) theta -> (C, G, n) normal responses."""
    C, G = theta.shape
    return theta[:, :, None] + SIGMA * rng.normal((C, G, n))


def make_logistic_calibration_model(G: int, n: int) -> ModelSpec:
    """Twin of tests/test_geweke_newton.py's model: y_gi ~
    Bernoulli(sigmoid(theta_g)), theta ~ N(mu, tau), mu ~ N(0, S0),
    tau ~ HalfNormal(TAU0) as log tau; theta runs Newton-MH with analytic
    scalar-unit hooks (grad and Hessian (C, G)), mu and log_tau RW-MH."""

    def _lik(state, data):
        th = state["theta"][:, :, None]
        return torch.sum(data["y"] * th - torch.nn.functional.softplus(th),
                         dim=-1)

    def _gprior(state):
        tau = torch.exp(state["log_tau"])[:, None]
        return logpdf_normal(state["theta"], state["mu"][:, None], tau)

    def cond(name, value, state, data):
        state = {**state, name: value}
        if name == "theta":
            return _lik(state, data) + _gprior(state)
        if name == "mu":
            return (torch.sum(_gprior(state), dim=-1)
                    + logpdf_normal(state["mu"], 0.0, S0_LOGIT))
        if name == "log_tau":
            lt = state["log_tau"]
            return (torch.sum(_gprior(state), dim=-1)
                    + logpdf_halfnormal(torch.exp(lt), TAU0_LOGIT) + lt)
        raise KeyError(name)

    def joint(state, data):
        lt = state["log_tau"]
        return (
            torch.sum(_lik(state, data) + _gprior(state), dim=-1)
            + logpdf_normal(state["mu"], 0.0, S0_LOGIT)
            + logpdf_halfnormal(torch.exp(lt), TAU0_LOGIT) + lt
        )

    def self_vgh(value, data):
        s_g = torch.sum(data["y"], dim=-1)                  # (C, G)
        sig = torch.sigmoid(value)
        v = s_g * value - n * torch.nn.functional.softplus(value)
        return v, s_g - n * sig, n * sig * (1.0 - sig)

    def rest_vgh(value, state, data):
        mu = state["mu"][:, None]
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])[:, None]
        diff = value - mu
        v = (-0.5 * diff * diff * inv_tau2 + 0.5 * torch.log(inv_tau2)
             - 0.9189385332046727)
        return v, -diff * inv_tau2, inv_tau2.expand_as(value)

    def prior_sample(rng, data, chains):
        mu = S0_LOGIT * rng.normal((chains,))
        tau = TAU0_LOGIT * torch.abs(rng.normal((chains,)))
        theta = mu[:, None] + tau[:, None] * rng.normal((chains, G))
        return {"theta": theta, "mu": mu, "log_tau": torch.log(tau)}

    return ModelSpec(
        name="calibration_hier_logistic",
        blocks=(
            Block("theta", (G,), units=G, algorithm="newton"),
            Block("mu", (), init_scale=0.5),
            Block("log_tau", (), init_scale=0.3),
        ),
        init_state=prior_sample,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        cond_cached_newton={"theta": (self_vgh, rest_vgh)},
    )


def sample_y_logit(rng, theta, n):
    """(C, G) theta -> (C, G, n) Bernoulli(sigmoid(theta)) responses."""
    C, G = theta.shape
    logp = torch.nn.functional.logsigmoid(theta)[:, :, None]
    return (rng.log_uniform((C, G, n)) < logp).float()


# ---- the twins against the reference's models ----------------------------

C, G, N = 7, 5, 3


def _np(a):
    return np.array(a, np.float32)


def _state(seed, logit=False):
    r = np.random.default_rng(seed)
    st = {
        "theta": r.normal(0.0, 1.2, (C, G)),
        "mu": r.normal(0.0, 1.0, C),
        "log_tau": r.normal(-0.3, 0.4, C),
    }
    y = (r.random((C, G, N)) < 0.4) if logit else r.normal(0.5, 1.5, (C, G, N))
    return {k: _np(v) for k, v in st.items()}, _np(y)


def _both(st, y):
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    return jst, {"y": jnp.asarray(y)}, tst, {"y": torch.from_numpy(y)}


@pytest.mark.parametrize("logit", [False, True])
def test_cond_and_joint_match_the_reference(logit):
    st, y = _state(1 + logit, logit)
    if logit:
        jm, tm = j_make_logit(G, N), make_logistic_calibration_model(G, N)
    else:
        jm = jcal.make_calibration_model(G, N)
        tm = make_calibration_model(G, N)
    jst, jd, tst, td = _both(st, y)
    r = np.random.default_rng(9)
    for name in ("theta", "mu", "log_tau"):
        value = _np(st[name] + 0.3 * r.standard_normal(st[name].shape))
        got = tm.cond_logdensity(name, torch.from_numpy(value), tst, td)
        want = jm.cond_logdensity(name, jnp.asarray(value), jst, jd)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tm.joint_logdensity(tst, td).numpy(),
                               _np(jm.joint_logdensity(jst, jd)), **TOL)
    broken = make_broken_model(G, N)
    jbroken = jcal.make_broken_model(G, N)
    np.testing.assert_allclose(
        broken.cond_logdensity("log_tau", tst["log_tau"], tst, td).numpy(),
        _np(jbroken.cond_logdensity("log_tau", jst["log_tau"], jst, jd)),
        **TOL)


def test_newton_hooks_match_the_reference():
    st, y = _state(3, logit=True)
    jm, tm = j_make_logit(G, N), make_logistic_calibration_model(G, N)
    jst, jd, tst, td = _both(st, y)
    (js, jr), (ts, tr) = jm.cond_cached_newton["theta"], \
        tm.cond_cached_newton["theta"]
    v = st["theta"] + 0.2
    for got, want in zip(ts(torch.from_numpy(v), td), js(jnp.asarray(v), jd)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for got, want in zip(tr(torch.from_numpy(v), tst, td),
                         jr(jnp.asarray(v), jst, jd)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("grad_asis", [False, True, "broken-q"])
def test_asis_moves_match_the_reference(grad_asis):
    """One interweaving move of each form on the same state, data, scale
    and replayed noise: positions and alpha match."""
    st, y = _state(4)
    jm = jcal.make_calibration_model(G, N, grad_asis=grad_asis)
    tm = make_calibration_model(G, N, grad_asis=grad_asis)
    jst, jd, tst, td = _both(st, y)
    scale = _np(np.full((C, 1), 0.7))
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    noise = [_np(jax.random.normal(k1, (C,), jnp.float32)),
             _np(jnp.log(jax.random.uniform(k2, (C,), jnp.float32,
                                            minval=TINY)))]
    jpos, _, jalpha = jm.joint_moves["asis_tau"](key, jst, {},
                                                 jnp.asarray(scale), jd)
    tpos, _, talpha = tm.joint_moves["asis_tau"](
        ReplayRNG(noise), tst, {}, torch.from_numpy(scale), td)
    for k in jpos:
        np.testing.assert_allclose(tpos[k].numpy(), _np(jpos[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(talpha.numpy(), _np(jalpha), **TOL)


def test_prior_samples_have_the_prior_moments():
    """The twins' prior draws: mu ~ N(0, S0^2), tau ~ |N(0, TAU0^2)|,
    theta | mu, tau ~ N(mu, tau^2), within 5 standard errors."""
    n = 200_000
    for model, s0, tau0 in (
        (make_calibration_model(G, N), S0, TAU0),
        (make_logistic_calibration_model(G, N), S0_LOGIT, TAU0_LOGIT),
    ):
        d = model.prior_sample(SweepRNG(7, "cpu"), None, n)
        tau = torch.exp(d["log_tau"]).double()
        mu = d["mu"].double()
        z = ((d["theta"].double() - mu[:, None]) / tau[:, None]).reshape(-1)
        for got, want, sd in (
            (float(mu.mean()), 0.0, s0),
            (float((mu * mu).mean()), s0**2, s0**2 * math.sqrt(2.0)),
            (float(tau.mean()), tau0 * math.sqrt(2.0 / math.pi), tau0),
            (float(z.mean()), 0.0, 1.0),
            (float((z * z).mean()), 1.0, math.sqrt(2.0)),
        ):
            assert abs(got - want) < 5.0 * sd / math.sqrt(n), (got, want)


# ---- repair 1: Newton-MH on scalar units ----------------------------------

def _newton_setup(seed):
    st, y = _state(seed, logit=True)
    jst, jd, tst, td = _both(st, y)
    jm, tm = j_make_logit(G, N), make_logistic_calibration_model(G, N)
    block = tm.block("theta")
    r = np.random.default_rng(seed + 10)
    log_scale = _np(r.normal(0.0, 0.2, (C, G)))
    return st, jst, jd, tst, td, jm, tm, block, log_scale


@pytest.mark.parametrize("frozen", [False, True])
def test_newton_update_on_scalar_units_matches_the_reference(frozen):
    """Refresh and frozen, from the same carried cache; the frozen metric
    is a Hessian from another state (a constant, as at warmup end)."""
    st, jst, jd, tst, td, jm, tm, block, log_scale = _newton_setup(6)
    js, _ = jm.cond_cached_newton["theta"]
    v, g, h = js(jst["theta"], jd)
    if frozen:
        h = js(jst["theta"] + 0.5, jd)[2]
    jcache = {"v": v, "g": g, "h": h}
    tcache = {k: torch.from_numpy(_np(a)) for k, a in jcache.items()}
    key = jax.random.key(8)
    k_eps, k_u = jax.random.split(key)
    noise = [_np(jax.random.normal(k_eps, (C, G, 1), jnp.float32)),
             _np(jnp.log(jax.random.uniform(k_u, (C, G), jnp.float32,
                                            minval=TINY)))]
    jout = j_newton_update(key, jm.block("theta"), jm, jst,
                           jnp.asarray(log_scale), None, jd, cache=jcache,
                           frozen=frozen)
    rng = ReplayRNG(noise)
    tout = newton_update(rng, block, tm, tst, torch.from_numpy(log_scale),
                         td, cache=tcache, frozen=frozen)
    assert rng.remaining == 0
    np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), **TOL)
    np.testing.assert_allclose(tout[1].numpy(), _np(jout[1]), **TOL)
    for k in ("v", "g", "h"):
        np.testing.assert_allclose(tout[2][k].numpy(), _np(jout[2][k]),
                                   **TOL, err_msg=k)
    if frozen:
        assert tout[2]["h"] is tcache["h"]
    # without a cache (refresh only): the same update
    if not frozen:
        jout = j_newton_update(key, jm.block("theta"), jm, jst,
                               jnp.asarray(log_scale), None, jd)
        tout = newton_update(ReplayRNG(noise), block, tm, tst,
                             torch.from_numpy(log_scale), td)
        np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), **TOL)
        np.testing.assert_allclose(tout[1].numpy(), _np(jout[1]), **TOL)


def _sweep_noise(key):
    """The noise one reference sweep of the logistic calibration model
    draws (kernels/gibbs.py: block i's repeat r keyed fold_in(fold_in(
    key_sweep, i), r); Newton then RW split (k_eps, k_u))."""
    _, key_sweep = jax.random.split(key)
    out = []
    for i, shape in ((0, (C, G, 1)), (1, (C,)), (2, (C,))):
        kr = jax.random.fold_in(jax.random.fold_in(key_sweep, i), 0)
        k_eps, k_u = jax.random.split(kr)
        u_shape = (C, G) if i == 0 else (C, 1)
        out += [jax.random.normal(k_eps, shape, jnp.float32),
                jnp.log(jax.random.uniform(k_u, u_shape, jnp.float32,
                                           minval=TINY))]
    return [_np(a) for a in out]


@pytest.mark.parametrize("frozen", [False, True])
def test_sweep_with_scalar_newton_units_matches_the_reference(frozen):
    """One make_sweep of the logistic calibration model (theta Newton on
    scalar units, mu and log_tau RW-MH) from the reference's initial
    state, its noise replayed: warmup (refresh, adapting) and sampling
    (frozen) sweeps."""
    st, y = _state(11, logit=True)
    jm, tm = j_make_logit(G, N), make_logistic_calibration_model(G, N)
    kw = dict(scale_per_unit=True, newton_freeze=True)
    jcfg = JSamplerConfig(kernel=JKernelConfig(**kw),
                          run=JRunConfig(chains=C, log_every_segment=False))
    tcfg = SamplerConfig(kernel=KernelConfig(**kw),
                         run=RunConfig(chains=C, log_every_segment=False))
    jd = {"y": jnp.asarray(y)}
    jstate = j_init_state(jm, jcfg, jax.random.key(12), jd)
    jnew = j_make_sweep(jm, jcfg)(jstate, jd, adapt=not frozen)
    tstate = state_from_numpy(
        {k: _np(v) for k, v in jstate.position.items()},
        {k: _np(v) for k, v in jstate.log_scale.items()},
        {k: _np(v) for k, v in jstate.accept_sum.items()},
        {k: None if c is None else {kk: _np(vv) for kk, vv in c.items()}
         for k, c in jstate.cache.items()},
        t=int(jstate.t), device="cpu",
    )
    rng = ReplayRNG(_sweep_noise(jstate.key))
    tnew = make_sweep(tm, tcfg)(tstate, {"y": torch.from_numpy(y)},
                                not frozen, rng)
    assert rng.remaining == 0
    for part in ("position", "log_scale", "accept_sum"):
        for k, v in getattr(jnew, part).items():
            np.testing.assert_allclose(getattr(tnew, part)[k].numpy(),
                                       _np(v), **TOL, err_msg=f"{part} {k}")
    for k in ("v", "g", "h"):
        np.testing.assert_allclose(tnew.cache["theta"][k].numpy(),
                                   _np(jnew.cache["theta"][k]), **TOL,
                                   err_msg=k)


# ---- repair 2: opaque data ------------------------------------------------

def test_init_kernel_state_sweep_and_sample_take_dict_data():
    """Data a plain dict {"y": (C, G, n)}: the carry lands on the
    position's device, one sweep runs, and engine.sample takes the device
    from the dict's tensor."""
    model = make_calibration_model(G, N)
    cfg = SamplerConfig(run=RunConfig(chains=C, warmup=20, draws=30,
                                      log_every_segment=False))
    rng = SweepRNG(3, "cpu")
    theta0 = model.prior_sample(rng, None, C)["theta"]
    data = {"y": sample_y(rng, theta0, N)}
    state = init_kernel_state(model, cfg, rng, data)
    assert state.log_scale["theta"].device.type == "cpu"
    state = make_sweep(model, cfg)(state, data, True, rng)
    for v in state.position.values():
        assert bool(torch.isfinite(v).all())
    post = sample(model, data, cfg)
    assert post.draws["theta"].shape == (C, 30, G)
    assert bool(torch.isfinite(post.draws["mu"]).all())
