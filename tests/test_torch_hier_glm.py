"""The port's generic hierarchical GLM (nestmc_torch/models/hier_glm.py)
held against nestmc.models.hier_glm, hook by hook.

Data of each family are made from a seed with numpy (masked rows at a
group's end, start and middle; binomial with varying trials, one of them
zero) and passed both to nestmc (NestedData of jnp arrays) and to the port;
the parameters are carried across with state_from_numpy. For all five
families, fused and not: every block's cond_logdensity, the joint, the
self and rest parts of cond_cached, cond_cached_grad and
cond_cached_newton, the derived group_loglik; the mu / log tau Gibbs
draws and the interweaving move on the reference's replayed noise (rtol
1e-5, atol 1e-4; float32). Twins of tests/test_hier_glm_delegate.py (the
binomial identities against the plain path, the pmf-scale group_loglik,
count-space sample_data, the bernoulli delegation), of
tests/test_hier_glm.py:56 (unknown family), of
tests/test_hier_glm_poisson_fused.py:59 (the fused tables) and of
tests/test_hier_glm_newton.py:85 (the gaussian Newton step is an exact
Gibbs draw).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.data import NestedData as JNestedData
from nestmc.models.hier_glm import make_hier_glm as j_make
from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.data import from_numpy
from nestmc_torch.kernels.newton import newton_update
from nestmc_torch.kernels.state import init_kernel_state, state_from_numpy
from nestmc_torch.models import make_hier_glm, synth_glm
from nestmc_torch.rng import ReplayRNG, SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401

FAMILIES = ("gaussian", "binomial", "bernoulli", "poisson", "negbin")
AUX = {"gaussian": "log_sigma", "negbin": "log_r"}
TOL = dict(rtol=1e-5, atol=1e-4)
TINY = jnp.finfo(jnp.float32).tiny
C, G, N, P = 4, 6, 7, 3


def _np(a):
    return np.array(a, np.float32)


def glm_data(family, seed=0, G=G, n=N, p=P, masked=True):
    """(reference NestedData, port NestedData) of one family, the same
    numpy arrays in both."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((G, n, p)).astype(np.float32)
    x[:, :, 0] = 1.0
    beta = 0.3 + 0.3 * r.standard_normal((G, p))
    eta = np.einsum("gnp,gp->gn", x, beta)
    mask = np.ones((G, n), np.float32)
    if masked:
        mask[0, n - 3:] = 0.0
        mask[2, :2] = 0.0
        mask[3, n // 2] = 0.0
    extra = {}
    if family == "gaussian":
        y = eta + 0.7 * r.standard_normal((G, n))
    elif family == "binomial":
        m = r.integers(1, 8, (G, n)).astype(np.float32)
        m[1, 1] = 0.0
        y = r.binomial(m.astype(np.int64), 1.0 / (1.0 + np.exp(-eta)))
        extra["trials"] = m
    elif family == "bernoulli":
        y = r.random((G, n)) < 1.0 / (1.0 + np.exp(-eta))
    elif family == "poisson":
        y = r.poisson(np.exp(eta))
    else:
        y = r.poisson(np.exp(eta) / 5.0 * r.gamma(5.0, size=(G, n)))
    y = np.asarray(y, np.float32) * mask
    jdata = JNestedData(
        y=jnp.asarray(y), mask=jnp.asarray(mask),
        sizes=jnp.asarray((mask > 0.5).sum(1).astype(np.int32)),
        x=jnp.asarray(x), extra={k: jnp.asarray(v) for k, v in extra.items()},
    )
    return jdata, from_numpy(x, y, mask, device="cpu", extra=extra)


def glm_state(family, seed=1, C=C, G=G, p=P):
    """A numpy position of the family's blocks."""
    r = np.random.default_rng(seed)
    st = {"beta": 0.3 * r.standard_normal((C, G, p)),
          "mu": 0.3 * r.standard_normal((C, p)),
          "log_tau": -0.5 + 0.3 * r.standard_normal((C, p))}
    if family in AUX:
        st[AUX[family]] = 0.2 * r.standard_normal(C)
    return {k: _np(v) for k, v in st.items()}


def both(st):
    """(jnp dict, port position) of one numpy position."""
    tpos = state_from_numpy(st, {}, {}, {}, device="cpu").position
    return {k: jnp.asarray(v) for k, v in st.items()}, tpos


def close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), _np(j), **tol,
                               err_msg=msg)


def _models(family, fused, prior="invgamma"):
    jdata, tdata = glm_data(family)
    kw = dict(family=family, fused=fused, tau_prior=prior)
    return jdata, tdata, j_make(jdata, **kw), make_hier_glm(tdata, **kw)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_hooks_match_reference(family, fused):
    jdata, tdata, jm, tm = _models(family, fused)
    assert tm.name == jm.name
    assert [b.name for b in tm.blocks] == [b.name for b in jm.blocks]
    st = glm_state(family)
    js, ts = both(st)
    for b in jm.blocks:
        moved = {k: v + 0.05 for k, v in st.items()}
        jv, tv = both(moved)
        close(tm.cond_logdensity(b.name, tv[b.name], ts, tdata),
              jm.cond_logdensity(b.name, jv[b.name], js, jdata),
              msg=f"cond {b.name}")
    close(tm.joint_logdensity(ts, tdata), jm.joint_logdensity(js, jdata),
          msg="joint")
    close(tm.derived["group_loglik"](ts), jm.derived["group_loglik"](js),
          msg="group_loglik")
    assert set(tm.derived) == set(jm.derived)
    for field in ("cond_cached", "cond_cached_grad", "cond_cached_newton"):
        tt, jt = getattr(tm, field), getattr(jm, field)
        assert set(tt) == set(jt), field
        for name, (jself, jrest) in jt.items():
            tself, trest = tt[name]
            for tout, jout in (
                (tself(ts[name], tdata), jself(js[name], jdata)),
                (trest(ts[name], ts, tdata), jrest(js[name], js, jdata)),
            ):
                tout = tout if isinstance(tout, tuple) else (tout,)
                jout = jout if isinstance(jout, tuple) else (jout,)
                for i, (a, b) in enumerate(zip(tout, jout)):
                    close(a, np.broadcast_to(_np(b), a.shape),
                          msg=f"{field} {i}")


@pytest.mark.parametrize("prior", ["invgamma", "halfnormal"])
@pytest.mark.parametrize("family", ["poisson", "gaussian"])
def test_gibbs_draws_match_reference(family, prior):
    """The conjugate mu draw (and the inverse-gamma log tau draw) on the
    reference's noise."""
    jdata, tdata, jm, tm = _models(family, True, prior)
    st = glm_state(family)
    js, ts = both(st)
    key = jax.random.key(5)
    assert set(tm.gibbs_draws) == set(jm.gibbs_draws)
    for name, jfn in jm.gibbs_draws.items():
        if name == "mu":
            noise = jax.random.normal(key, (C, P))
        else:
            noise = jax.random.gamma(key, 2.0 + 0.5 * G, shape=(C, P),
                                     dtype=jnp.float32)
        out = tm.gibbs_draws[name](ReplayRNG([_np(noise)]), ts, tdata)
        close(out, jfn(key, js, jdata), msg=name)


def _asis_noise(key, grad_q=None):
    """The reference interweave's noise: eps from k1 (its (C, 2p) Langevin
    / Laplace draw for hier_logistic's grad modes), then log u from k2."""
    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, (C, grad_q or P), jnp.float32)
    logu = jnp.log(jax.random.uniform(k2, (C,), jnp.float32, minval=TINY))
    return [_np(eps), _np(logu)]


def _cache(jm, kind, js, jdata):
    """A reference cache of ``kind`` at ``js``'s beta."""
    if kind == "none":
        return None
    if kind == "rw":
        return jm.cond_cached["beta"][0](js["beta"], jdata)
    if kind == "grad":
        v, g = jm.cond_cached_grad["beta"][0](js["beta"], jdata)
        return {"v": v, "g": g}
    v, g, h = jm.cond_cached_newton["beta"][0](js["beta"], jdata)
    return {"v": v, "g": g, "h": h}


def _tcache(c):
    if c is None:
        return None
    if isinstance(c, dict):
        return {k: torch.as_tensor(_np(v)) for k, v in c.items()}
    return torch.as_tensor(_np(c))


@pytest.mark.parametrize("family,kind,frozen", [
    ("poisson", "none", False), ("poisson", "rw", False),
    ("poisson", "grad", False), ("poisson", "newton", False),
    ("poisson", "newton", True), ("gaussian", "newton", False),
    ("gaussian", "newton", True), ("negbin", "none", False),
    ("binomial", "rw", False), ("binomial", "newton", False),
    ("binomial", "newton", True),
])
def test_asis_move_matches_reference(family, kind, frozen):
    """One interweaving move from every cache kind on the reference's
    noise: the new position, the refreshed cache and alpha."""
    jdata, tdata, jm, tm = _models(family, True)
    if kind == "grad":
        # the poisson fused step's MALA cache is the self (v, g) pair
        assert "beta" in tm.cond_cached_grad
    st = glm_state(family, seed=3)
    js, ts = both(st)
    jc = _cache(jm, kind, js, jdata)
    key = jax.random.key(11)
    scale = jnp.full((C, 1), 0.15, jnp.float32)
    jpos, jcache, jalpha = jm.joint_moves["asis_tau"](
        key, js, {"beta": jc}, scale, jdata, frozen=frozen)
    grad_q = 2 * P if family == "binomial" and kind == "newton" else None
    rng = ReplayRNG(_asis_noise(key, grad_q))
    tpos, tcache, talpha = tm.joint_moves["asis_tau"](
        rng, ts, {"beta": _tcache(jc)}, torch.full((C, 1), 0.15), tdata,
        frozen=frozen)
    assert rng.remaining == 0
    assert float(jnp.mean(jalpha)) > 0.0, "no accepted move: no power"
    close(talpha, jalpha, dict(rtol=2e-3, atol=2e-4), "alpha")
    assert set(tpos) == set(jpos)
    for k in jpos:
        close(tpos[k], jpos[k], dict(rtol=1e-4, atol=1e-3), k)
    assert set(tcache) == set(jcache)
    if jc is not None:
        tc, jcc = tcache["beta"], jcache["beta"]
        for k in (tc if isinstance(tc, dict) else {"v": None}):
            a = tc[k] if isinstance(tc, dict) else tc
            b = jcc[k] if isinstance(jcc, dict) else jcc
            close(a, b, dict(rtol=1e-4, atol=1e-3), f"cache {k}")


def test_unknown_family_rejected():
    data, _ = synth_glm(1, family="gaussian", G=4, n=3, device="cpu")
    with pytest.raises(ValueError, match="family"):
        make_hier_glm(data, family="weibull")


def test_fused_tables_wired():
    data, _ = synth_glm(1, family="poisson", G=4, n=5, p=2, device="cpu")
    m = make_hier_glm(data, family="poisson")
    for table in (m.fused_updates, m.fused_updates_mala,
                  m.fused_updates_newton):
        assert "beta" in table
    plain = make_hier_glm(data, family="poisson", fused=False)
    assert plain.fused_updates == {}
    assert plain.fused_updates_mala == {}
    assert plain.fused_updates_newton == {}
    # aux families (the likelihood reads log_sigma / log_r) have no kernel
    for fam in ("gaussian", "negbin"):
        d, _ = synth_glm(2, family=fam, G=4, n=5, p=2, device="cpu")
        assert make_hier_glm(d, family=fam).fused_updates == {}


def test_gaussian_newton_is_exact_gibbs():
    """The gaussian beta conditional is exactly Gaussian: acceptance 1."""
    data, _ = synth_glm(5, family="gaussian", G=8, n=12, p=3, device="cpu")
    model = make_hier_glm(data, family="gaussian")
    cfg = SamplerConfig(kernel=KernelConfig(algorithm="newton"),
                        run=RunConfig(chains=16, log_every_segment=False))
    state = init_kernel_state(model, cfg, SweepRNG(2, "cpu"), data)
    _, alpha, _ = newton_update(
        SweepRNG(11, "cpu"), model.block("beta"), model, state.position,
        state.log_scale["beta"], data, cache=state.cache["beta"],
    )
    assert float(alpha.min()) > 0.9999, float(alpha.min())


# ---- twins of tests/test_hier_glm_delegate.py ----


@pytest.fixture(scope="module")
def binom_setup():
    data, _ = synth_glm(0, family="binomial", G=12, n=8, p=3, trials=7,
                        device="cpu")
    fused = make_hier_glm(data, family="binomial", tau_prior="invgamma")
    plain = make_hier_glm(data, family="binomial", tau_prior="invgamma",
                          fused=False)
    state = plain.init_state(SweepRNG(1, "cpu"), data, 5)
    return data, fused, plain, state


def _log_binom(data):
    m = data.extra["trials"]
    return torch.sum(
        (torch.lgamma(m + 1.0) - torch.lgamma(data.y + 1.0)
         - torch.lgamma(m - data.y + 1.0)) * data.mask, dim=-1)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)


def test_delegation_engages_fused_tables(binom_setup):
    _, fused, plain, _ = binom_setup
    assert fused.name == "hier_glm_binomial"
    for table in (fused.fused_updates, fused.fused_updates_mala,
                  fused.fused_updates_newton):
        assert "beta" in table
    assert plain.fused_updates == {}


def test_beta_conditional_matches_up_to_constant(binom_setup):
    data, fused, plain, state = binom_setup
    v = state["beta"] + 0.1
    cf = fused.cond_logdensity("beta", v, state, data)
    cp = plain.cond_logdensity("beta", v, state, data)
    _close(cf + _log_binom(data)[None, :], cp, 2e-4, 2e-4)


def test_hyper_conditionals_match_exactly(binom_setup):
    data, fused, plain, state = binom_setup
    for name in ("mu", "log_tau"):
        v = state[name] + 0.05
        _close(fused.cond_logdensity(name, v, state, data),
               plain.cond_logdensity(name, v, state, data), 2e-5, 2e-5)


def test_joint_matches_up_to_constant(binom_setup):
    data, fused, plain, state = binom_setup
    const = float(_log_binom(data).sum())
    _close(fused.joint_logdensity(state, data) + const,
           plain.joint_logdensity(state, data), 2e-4, 2e-3)


def test_newton_hooks_match(binom_setup):
    data, fused, plain, state = binom_setup
    vf, gf, hf = fused.cond_cached_newton["beta"][0](state["beta"], data)
    vp, gp, hp = plain.cond_cached_newton["beta"][0](state["beta"], data)
    _close(vf + _log_binom(data)[None, :], vp, 2e-4, 2e-4)
    _close(gf, gp, 2e-4, 2e-4)
    _close(hf, hp, 2e-4, 2e-4)


def test_group_loglik_restores_pmf_scale(binom_setup):
    _, fused, plain, state = binom_setup
    _close(fused.derived["group_loglik"](state),
           plain.derived["group_loglik"](state), 2e-4, 2e-4)


def test_sample_data_stays_in_count_space(binom_setup):
    data, fused, _, state = binom_setup
    d2 = fused.sample_data(SweepRNG(3, "cpu"), state, data)
    y, m = d2.y.numpy(), data.extra["trials"].numpy()
    assert (y >= 0).all() and (y <= m).all()
    np.testing.assert_allclose(y, np.round(y))  # counts, original space
    assert "trials" in d2.extra  # the form the Geweke loop needs


def test_bernoulli_delegates_to_hier_logistic():
    data, _ = synth_glm(2, family="bernoulli", G=10, n=6, p=2, device="cpu")
    model = make_hier_glm(data, family="bernoulli")
    assert model.name == "hier_glm_bernoulli"
    assert "beta" in model.fused_updates
    plain = make_hier_glm(data, family="bernoulli", fused=False)
    state = plain.init_state(SweepRNG(4, "cpu"), data, 4)
    # no binomial coefficient: the conditionals match exactly
    _close(model.cond_logdensity("beta", state["beta"], state, data),
           plain.cond_logdensity("beta", state["beta"], state, data),
           2e-4, 2e-4)


def test_reweighted_transform_computed_once(binom_setup, monkeypatch):
    """The hooks reuse the build-time data's transform whenever they get
    that same object (the sampler's data), and transform other data."""
    import dataclasses

    from nestmc_torch.models import hier_glm

    data, fused, _, state = binom_setup
    calls = []
    orig = hier_glm._reweighted

    def counted(d):
        calls.append(d)
        return orig(d)

    monkeypatch.setattr(hier_glm, "_reweighted", counted)
    v1 = fused.cond_cached_newton["beta"][0](state["beta"], data)[0]
    fused.cond_logdensity("beta", state["beta"], state, data)
    fused.joint_moves["asis_tau"](SweepRNG(0, "cpu"), state, {}, torch.full(
        (5, 1), 0.1), data)
    assert calls == []
    other = dataclasses.replace(data, y=data.y.clone())
    v2 = fused.cond_cached_newton["beta"][0](state["beta"], other)[0]
    assert len(calls) == 1
    _close(v1, v2, 0.0, 0.0)


def test_xxt_packed_matches_reference():
    """The weighted packed X^T W X of ops/loglik against the reference's
    _xxt_packed, in smallchol's packing order."""
    from nestmc.ops.loglik import _xxt_packed
    from nestmc_torch.ops.loglik import xxt_packed

    r = np.random.default_rng(4)
    x = _np(r.standard_normal((G, N, P)))
    w = _np(r.random((C, G, N)) * 3.0)
    close(xxt_packed(torch.from_numpy(x), torch.from_numpy(w)),
          _xxt_packed(jnp.asarray(x), jnp.asarray(w)), dict(rtol=1e-5,
                                                            atol=1e-5))


def test_rng_binomial_and_tensor_gamma():
    """SweepRNG's binomial (tensor trials) and gamma with a per-chain
    concentration: their moments; ReplayRNG replays both by shape."""
    rng = SweepRNG(0, "cpu")
    m = torch.tensor([0.0, 3.0, 10.0]).expand(200_000, 3)
    y = rng.binomial(m, torch.full_like(m, 0.3))
    assert y.dtype == torch.float32 and bool((y <= m).all())
    np.testing.assert_allclose(y.mean(0).numpy(), [0.0, 0.9, 3.0],
                               atol=0.02)
    a = torch.tensor([[0.5], [2.0], [7.0]])
    g = rng.gamma(a, (3, 100_000))
    np.testing.assert_allclose(g.mean(1).numpy(), [0.5, 2.0, 7.0],
                               rtol=0.02)
    np.testing.assert_allclose(g.var(1).numpy(), [0.5, 2.0, 7.0],
                               rtol=0.05)
    rp = ReplayRNG([np.ones((2, 3), np.float32)] * 2)
    assert rp.binomial(torch.ones(2, 3), torch.full((2, 3), 0.5)).shape == (
        2, 3)
    assert rp.poisson(torch.ones(2, 3)).shape == (2, 3)
