"""The fused hooks of the port's hier_glm (the plain versions the CUDA
wrappers run for CPU tensors) against the reference's, on the same data,
state and noise; the interweave's cache refresh; the in-kernel R-hat fold
through the binomial delegate's wrapped hooks.

- Poisson family: the RW-MH, MALA and Newton (refresh and frozen) fused
  hooks, dense and masked, against nestmc's fused hooks in interpret mode
  with the same external (eps, log u), as
  tests/test_hier_glm_poisson_fused.py runs them, and against nestmc's
  unfused update of the same key.
- Binomial (the logistic delegate on reweighted data): the three fused
  hooks against nestmc's unfused kernels/{rwmh,mala,newton}.py update of
  its own delegate model with the same key (the reference's fused
  logistic hooks draw on-core noise only), and its carried cache.
Tolerances as tests/test_hier_glm_poisson_fused.py: alpha rtol 2e-3 /
atol 2e-4, beta atol 2e-4, v rtol 1e-4 / atol 2e-4, g and h rtol 1e-3 /
atol 2e-4; the frozen step returns the carried h itself.
- The twin of tests/test_hier_glm_newton.py:130: after sweeps that
  interleave interweaves with cached updates, the carried beta cache equals
  the self hook at the final position (RW, MALA, Newton without freeze).
- rhat_fold_names(binomial model) == ("beta",) as for hier_logistic (the
  delegate's wrappers keep the hooks' signatures), and a full_rhat run
  with the fold in the step gives the streamed R-hat of a run whose hook
  hides it (the plain fold) within 1e-5.
- Newton-MH's Laplace trap: at a point far in a Poisson group's tail the
  port's fused Newton hook and nestmc's unfused update give the same
  vanishing alpha (< 1e-6), at the group's conditional mode a high one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig as JKernelConfig
from nestmc.config import RunConfig as JRunConfig
from nestmc.config import SamplerConfig as JSamplerConfig
from nestmc.data import NestedData as JNestedData
from nestmc.kernels.mala import mala_update as j_mala
from nestmc.kernels.newton import newton_update as j_newton
from nestmc.kernels.rwmh import rwmh_update as j_rwmh
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc.models.hier_glm import make_hier_glm as j_make
import nestmc_torch
from nestmc_torch.data import from_numpy
from nestmc_torch.kernels.gibbs import rhat_fold_names
from nestmc_torch.kernels.state import state_from_numpy
from nestmc_torch.models import make_hier_glm, synth_glm
from nestmc_torch.rng import ReplayRNG
from tests.test_torch_calibration import one_thread  # noqa: F401
from tests.test_torch_hier_glm import glm_data

ALPHA_TOL = dict(rtol=2e-3, atol=2e-4)
BETA_TOL = dict(rtol=0, atol=2e-4)
V_TOL = dict(rtol=1e-4, atol=2e-4)
G_TOL = dict(rtol=1e-3, atol=2e-4)
TINY = jnp.finfo(jnp.float32).tiny
C = 8


def _np(a):
    return np.array(a, np.float32)


def _cache_np(c):
    if c is None:
        return None
    if isinstance(c, dict):
        return {k: _np(v) for k, v in c.items()}
    return _np(c)


def _setup(family, algorithm, dense):
    jdata, tdata = glm_data(family, seed=31, G=6, n=7, masked=not dense)
    jm = j_make(jdata, family=family, tau_prior="invgamma")
    tm = make_hier_glm(tdata, family=family, tau_prior="invgamma")
    cfg = JSamplerConfig(kernel=JKernelConfig(algorithm=algorithm),
                         run=JRunConfig(chains=C, log_every_segment=False))
    js = j_init_state(jm, cfg, jax.random.key(4), jdata)
    ts = state_from_numpy(
        {k: _np(v) for k, v in js.position.items()},
        {k: _np(v) for k, v in js.log_scale.items()}, {},
        {k: _cache_np(c) for k, c in js.cache.items()}, device="cpu")
    return jdata, tdata, jm, tm, js, ts


def _noise(key, shape):
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    logu = jnp.log(jax.random.uniform(k_u, shape[:2], jnp.float32,
                                      minval=TINY))
    return _np(eps), _np(logu)


def _check(out, ref_beta, ref_cache, ref_alpha, kind, carried_h=None):
    new_beta, new_cache, alpha = out
    np.testing.assert_allclose(alpha.numpy(), _np(ref_alpha), **ALPHA_TOL)
    np.testing.assert_allclose(new_beta.numpy(), _np(ref_beta), **BETA_TOL)
    if kind == "rwmh":
        np.testing.assert_allclose(new_cache.numpy(), _np(ref_cache), **V_TOL)
        return
    np.testing.assert_allclose(new_cache["v"].numpy(), _np(ref_cache["v"]),
                               **V_TOL)
    np.testing.assert_allclose(new_cache["g"].numpy(), _np(ref_cache["g"]),
                               **G_TOL)
    if carried_h is not None:
        assert new_cache["h"] is carried_h
    elif kind == "newton":
        np.testing.assert_allclose(new_cache["h"].numpy(),
                                   _np(ref_cache["h"]), **G_TOL)


TABLE = {"rwmh": "fused_updates", "mala": "fused_updates_mala",
         "newton": "fused_updates_newton"}
UNFUSED = {"rwmh": j_rwmh, "mala": j_mala, "newton": j_newton}


@pytest.mark.parametrize("kind,frozen", [
    ("rwmh", False), ("mala", False), ("newton", False), ("newton", True)])
@pytest.mark.parametrize("dense", [False, True])
def test_poisson_fused_hooks_match_reference(kind, frozen, dense):
    jdata, tdata, jm, tm, js, ts = _setup("poisson", kind, dense)
    beta = js.position["beta"]
    key = jax.random.key(7 + 10 * frozen)
    eps, logu = _noise(key, beta.shape)
    kw = {"frozen": frozen} if kind == "newton" else {}
    ref = getattr(jm, TABLE[kind])["beta"](
        key, js.position, js.cache, js.log_scale["beta"], jdata,
        noise=(jnp.asarray(eps), jnp.asarray(logu)), **kw)
    rng = ReplayRNG([eps, logu])
    out = getattr(tm, TABLE[kind])["beta"](
        rng, ts.position, ts.cache, ts.log_scale["beta"], tdata, **kw)
    assert rng.remaining == 0
    carried = ts.cache["beta"]["h"] if frozen else None
    _check(out, *ref, kind, carried)
    # and the reference's unfused update with the same key
    u_beta, u_alpha, u_cache = UNFUSED[kind](
        key, jm.block("beta"), jm, js.position, js.log_scale["beta"], None,
        jdata, cache=js.cache["beta"], **kw)
    _check(out, u_beta, u_cache, u_alpha, kind, carried)
    assert 0.0 < float(out[2].mean()) < 1.0


@pytest.mark.parametrize("kind,frozen", [
    ("rwmh", False), ("mala", False), ("newton", False), ("newton", True)])
def test_binomial_fused_hooks_match_reference(kind, frozen):
    jdata, tdata, jm, tm, js, ts = _setup("binomial", kind, dense=False)
    beta = js.position["beta"]
    key = jax.random.key(9 + 10 * frozen)
    kw = {"frozen": frozen} if kind == "newton" else {}
    u_beta, u_alpha, u_cache = UNFUSED[kind](
        key, jm.block("beta"), jm, js.position, js.log_scale["beta"], None,
        jdata, cache=js.cache["beta"], **kw)
    rng = ReplayRNG(list(_noise(key, beta.shape)))
    out = getattr(tm, TABLE[kind])["beta"](
        rng, ts.position, ts.cache, ts.log_scale["beta"], tdata, **kw)
    assert rng.remaining == 0
    _check(out, u_beta, u_cache, u_alpha, kind,
           ts.cache["beta"]["h"] if frozen else None)
    assert 0.0 < float(out[2].mean()) < 1.0


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton"])
def test_asis_refreshes_cache(algorithm):
    """After sweeps interleaving interweaves with cached updates, the
    carried beta cache equals the self hook at the current position."""
    data, _ = synth_glm(9, family="poisson", G=6, n=8, p=2, device="cpu")
    model = make_hier_glm(data, family="poisson", tau_prior="invgamma")
    cfg = nestmc_torch.SamplerConfig(
        # no freeze, so the Hessian must track the position too
        kernel=nestmc_torch.KernelConfig(algorithm=algorithm,
                                         newton_freeze=False),
        run=nestmc_torch.RunConfig(chains=4, warmup=30, draws=30,
                                   log_every_segment=False))
    post = nestmc_torch.sample(model, data, cfg)
    assert float(post.accept_rates["asis_tau"].mean()) > 0.02, \
        "no accepted interweaves: the test has no power"
    state = post.final_state
    cache, beta = state.cache["beta"], state.position["beta"]
    tol = dict(rtol=3e-5, atol=3e-5)
    gtol = dict(rtol=3e-4, atol=3e-4)
    if algorithm == "rwmh":
        ref = model.cond_cached["beta"][0](beta, data)
        np.testing.assert_allclose(cache.numpy(), ref.numpy(), **tol)
        return
    table = (model.cond_cached_grad if algorithm == "mala"
             else model.cond_cached_newton)
    ref = table["beta"][0](beta, data)
    np.testing.assert_allclose(cache["v"].numpy(), ref[0].numpy(), **tol)
    np.testing.assert_allclose(cache["g"].numpy(), ref[1].numpy(), **gtol)
    if algorithm == "newton":
        np.testing.assert_allclose(cache["h"].numpy(), ref[2].numpy(), **gtol)


def _fold_runs():
    data, _ = synth_glm(3, family="binomial", G=10, n=12, p=3, trials=6,
                        device="cpu")
    model = make_hier_glm(data, family="binomial", tau_prior="invgamma")
    cfg = nestmc_torch.SamplerConfig(
        kernel=nestmc_torch.KernelConfig(algorithm="newton"),
        run=nestmc_torch.RunConfig(chains=8, warmup=40, draws=60, seed=2,
                                   full_rhat=True, log_every_segment=False))
    return model, data, cfg


def test_rhat_fold_engages_through_the_delegate():
    model, data, cfg = _fold_runs()
    assert rhat_fold_names(model, cfg) == ("beta",)
    # the wrappers keep the step's signature (frozen, rhat_fold)
    hook = model.fused_updates_newton["beta"]
    assert hook.__wrapped__.__name__ == "fused_newton_beta_update"


def test_streamed_rhat_equals_plain_fold():
    model, data, cfg = _fold_runs()
    post = nestmc_torch.sample(model, data, cfg)
    hook = model.fused_updates_newton["beta"]

    def hidden(rng, position, cache, log_scale, data, frozen=False):
        return hook(rng, position, cache, log_scale, data, frozen=frozen)

    plain = dataclasses.replace(model,
                                fused_updates_newton={"beta": hidden})
    assert rhat_fold_names(plain, cfg) == ()
    post_p = nestmc_torch.sample(plain, data, cfg)
    assert set(post.full_rhat) == set(post_p.full_rhat) == {
        "beta", "mu", "log_tau"}
    for k, v in post.full_rhat.items():
        np.testing.assert_allclose(v.numpy(), post_p.full_rhat[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_newton_laplace_trap_is_the_references():
    """Newton-MH's parameter-free Laplace proposal cannot leave a point far
    in a Poisson group's tail (the reverse proposal's density there is
    tiny), which is why chip_smoke's poisson Newton run finds trapped
    groups: at such a point of one group of synth_glm(0, 'poisson', G=400)
    the port's fused Newton hook and nestmc's unfused update give the same
    vanishing alpha, and at the group's conditional mode a high one."""
    full, _ = synth_glm(0, family="poisson", G=400, n=10, p=3, device="cpu")
    x = full.x[257:258].double().numpy()
    y = full.y[257:258].double().numpy()
    mu = np.array([0.0, -0.03, 0.23])
    tau = np.array([0.30, 0.34, 0.32])
    b = mu.copy()
    for _ in range(50):                   # the conditional mode, float64
        r = np.exp(x[0] @ b)
        g = x[0].T @ (y[0] - r) - (b - mu) / tau**2
        h = (x[0].T * r) @ x[0] + np.diag(1.0 / tau**2)
        b = b + np.linalg.solve(h, g)
    tail = np.array([0.2931, 0.1290, 0.2217])
    beta = _np(np.stack([tail] * 4 + [b] * 4)[:, None, :])
    pos = {"beta": beta, "mu": _np(np.tile(mu, (8, 1))),
           "log_tau": _np(np.tile(np.log(tau), (8, 1)))}
    mask = np.ones((1, 10), np.float32)
    jdata = JNestedData(y=jnp.asarray(_np(y)), mask=jnp.asarray(mask),
                        sizes=jnp.asarray(np.array([10], np.int32)),
                        x=jnp.asarray(_np(x)), extra={})
    tdata = from_numpy(x, y, mask, device="cpu")
    jm = j_make(jdata, family="poisson", tau_prior="invgamma")
    tm = make_hier_glm(tdata, family="poisson", tau_prior="invgamma")
    jpos = {k: jnp.asarray(v) for k, v in pos.items()}
    v, g, h = jm.cond_cached_newton["beta"][0](jpos["beta"], jdata)
    jcache = {"v": v, "g": g, "h": h}
    key = jax.random.key(21)
    _, j_alpha, _ = j_newton(key, jm.block("beta"), jm, jpos,
                             jnp.zeros((8, 1)), None, jdata, cache=jcache)
    ts = state_from_numpy(pos, {}, {}, {"beta": _cache_np(jcache)},
                          device="cpu")
    _, _, t_alpha = tm.fused_updates_newton["beta"](
        ReplayRNG(list(_noise(key, (8, 1, 3)))), ts.position, ts.cache,
        torch.zeros(8, 1), tdata)
    np.testing.assert_allclose(t_alpha.numpy(), _np(j_alpha), **ALPHA_TOL)
    assert float(t_alpha[:4].max()) < 1e-6, t_alpha[:4]
    assert float(t_alpha[4:].mean()) > 0.5, t_alpha[4:]
