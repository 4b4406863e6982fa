"""The port's MALA and RW-MH pieces vs the reference, on the same data,
state and noise.

- The value-only loglik wrapper (its plain version runs for CPU tensors)
  vs nestmc.ops.loglik.logistic_loglik_padded and vs
  logistic_loglik_padded_pallas in interpret mode, dense and masked:
  rtol 1e-5 / atol 1e-4.
- The fused MALA step's plain version vs nestmc's fused_mala_logistic_step
  in interpret mode with external noise and vs the unfused mala_update with
  the cond_cached_grad cache (the contract of
  tests/test_mala_accept_fused.py:82), with and without the R-hat fold,
  dense and masked; a NaN proposal rejects (:112). The fused RW step's
  plain version vs rwmh_update with the cond_cached cache. Tolerances as
  tests/test_mala_accept_fused.py: alpha rtol 2e-3 / atol 2e-4; beta, v, g
  atol 2e-4; the fold rtol/atol 1e-5.
- The unfused mala_update and rwmh_update on the half-normal log_tau block
  (no cache) vs the reference's, and the closed-form log_tau gradient vs
  torch.autograd through cond_logdensity; Robbins-Monro adaptation vs
  nestmc.adapt.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.adapt import adapt_log_scale as j_adapt
from nestmc.config import KernelConfig as JKernelConfig
from nestmc.diagnostics import fold_rhat_scalars as j_fold_scalars
from nestmc.kernels.mala import mala_update as j_mala_update
from nestmc.kernels.rwmh import rwmh_update as j_rwmh_update
from nestmc.models import make_hier_logistic as j_make, synth_logistic
from nestmc.ops.loglik import logistic_loglik_padded as j_loglik
from nestmc.ops.pallas.loglik_logistic import logistic_loglik_padded_pallas
from nestmc.ops.pallas.mala_accept import fused_mala_logistic_step as j_step
from nestmc_torch import adapt
from nestmc_torch.config import KernelConfig
from nestmc_torch.data import from_numpy
from nestmc_torch.diagnostics import fold_rhat_scalars
from nestmc_torch.kernels import mala as tmala
from nestmc_torch.kernels.mala import mala_update
from nestmc_torch.kernels.rwmh import rwmh_update
from nestmc_torch.models import make_hier_logistic
from nestmc_torch.ops.cuda.loglik_logistic import logistic_loglik
from nestmc_torch.ops.cuda.mala_accept import (
    fused_mala_logistic_step,
    fused_mala_logistic_step_plain,
)
from nestmc_torch.ops.cuda.mh_accept import (
    fused_rwmh_logistic_step,
    fused_rwmh_logistic_step_plain,
)
from nestmc_torch.rng import ReplayRNG

OBS_TOL = dict(rtol=1e-5, atol=1e-4)
ALPHA_TOL = dict(rtol=2e-3, atol=2e-4)
TOL = dict(rtol=0, atol=2e-4)
TINY = jnp.finfo(jnp.float32).tiny


def _np(a):
    return np.array(a, np.float32)


def _t(a):
    return torch.as_tensor(_np(a))


def _setup(dense, C=8, G=13, n=9, p=3, seed=17):
    """Reference data, a half-normal model and a spread-out position."""
    data, _ = synth_logistic(jax.random.key(seed), G=G, n=n, p=p)
    if not dense:
        mask = np.array(data.mask)
        mask[0, n - 3:] = 0.0
        mask[5, n - 1:] = 0.0
        data = dataclasses.replace(
            data, mask=jnp.asarray(mask), y=data.y * jnp.asarray(mask)
        )
    model = j_make(data, loglik_impl="jnp")
    ks = jax.random.split(jax.random.key(seed + 1), 3)
    position = {
        "beta": 0.4 * jax.random.normal(ks[0], (C, G, p)),
        "mu": 0.3 * jax.random.normal(ks[1], (C, p)),
        "log_tau": -0.4 + 0.2 * jax.random.normal(ks[2], (C, p)),
    }
    tdata = from_numpy(data.x, data.y, data.mask, device="cpu")
    return data, model, position, tdata


def _noise(key, shape):
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    logu = jnp.log(jax.random.uniform(
        k_u, shape[:2], jnp.float32, minval=TINY
    ))
    return eps, logu


@pytest.mark.parametrize("dense", [False, True])
def test_value_only_loglik_matches_reference(dense):
    data, model, position, tdata = _setup(dense)
    beta = position["beta"]
    out = logistic_loglik(_t(beta), tdata.x, tdata.y, tdata.mask)
    np.testing.assert_allclose(
        out.numpy(), _np(j_loglik(beta, data.x, data.y, data.mask)),
        **OBS_TOL,
    )
    np.testing.assert_allclose(
        out.numpy(),
        _np(logistic_loglik_padded_pallas(beta, data.x, data.y, data.mask,
                                          interpret=True, dense=dense)),
        **OBS_TOL,
    )


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_fused_mala_step_matches_reference(dense, fold):
    data, model, position, tdata = _setup(dense)
    beta, mu, lt = position["beta"], position["mu"], position["log_tau"]
    C, G, p = beta.shape
    v, g = model.cond_cached_grad["beta"][0](beta, data)
    ls = jnp.full((C, G), -1.3)
    key = jax.random.key(77)
    eps, logu = _noise(key, (C, G, p))
    r = np.random.default_rng(5)
    fmean = r.standard_normal((2, G, p, C)).astype(np.float32)
    fm2 = r.random((2, G, p, C)).astype(np.float32)
    count = np.array([4.0, 0.0], np.float32)
    jfold = tfold = None
    if fold:
        jfold = (jnp.asarray(fmean), jnp.asarray(fm2),
                 j_fold_scalars(jnp.asarray(count), jnp.int32(4), 6))
        tfold = (_t(fmean), _t(fm2), fold_rhat_scalars(count, 4, 6))
    ref = j_step(
        key, beta, v, g, ls, mu, lt, data.x, data.y, data.mask,
        interpret=True, noise=(eps, logu), dense=dense, rhat_fold=jfold,
    )
    args = (_t(beta), _t(v), _t(g), _t(ls), _t(mu), _t(lt),
            tdata.x, tdata.y, tdata.mask)
    plain = fused_mala_logistic_step_plain(*args, (_t(eps), _t(logu)),
                                           rhat_fold=tfold)
    wrapped = fused_mala_logistic_step(*args, noise=(_t(eps), _t(logu)),
                                       rhat_fold=tfold)
    assert len(plain) == len(ref) == len(wrapped) == (6 if fold else 4)
    assert 0.05 < float(plain[3].mean()) < 0.999
    for out in (plain, wrapped):
        np.testing.assert_allclose(out[3].numpy(), _np(ref[3]), **ALPHA_TOL)
        for i in (0, 1, 2):
            np.testing.assert_allclose(out[i].numpy(), _np(ref[i]), **TOL)
        for i in range(4, len(out)):
            np.testing.assert_allclose(out[i].numpy(), _np(ref[i]),
                                       rtol=1e-5, atol=1e-5)

    # the unfused reference update with the cache and the same noise
    jpos = {**position, "beta": beta}
    rb, ralpha, rcache = j_mala_update(
        key, model.block("beta"), model, jpos, ls, None, data,
        cache={"v": v, "g": g},
    )
    np.testing.assert_allclose(plain[3].numpy(), _np(ralpha), **ALPHA_TOL)
    for a, b in zip(plain[:3], (rb, rcache["v"], rcache["g"])):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def test_fused_mala_nan_proposal_rejects():
    data, model, position, tdata = _setup(dense=True)
    beta = position["beta"]
    C, G, p = beta.shape
    v, g = model.cond_cached_grad["beta"][0](beta, data)
    eps = torch.full((C, G, p), float("inf"))
    logu = torch.full((C, G), -1.0)
    out = fused_mala_logistic_step_plain(
        _t(beta), _t(v), _t(g), torch.full((C, G), -1.3),
        _t(position["mu"]), _t(position["log_tau"]),
        tdata.x, tdata.y, tdata.mask, (eps, logu),
    )
    np.testing.assert_array_equal(out[3].numpy(), 0.0)
    np.testing.assert_array_equal(out[0].numpy(), _np(beta))
    np.testing.assert_array_equal(out[1].numpy(), _np(v))


@pytest.mark.parametrize("dense", [False, True])
def test_fused_rwmh_step_matches_rwmh_update(dense):
    data, model, position, tdata = _setup(dense)
    beta = position["beta"]
    C, G, p = beta.shape
    lik = model.cond_cached["beta"][0](beta, data)
    ls = jnp.full((C, G), -1.6)
    key = jax.random.key(78)
    eps, logu = _noise(key, (C, G, p))
    rb, ralpha, rlik = j_rwmh_update(
        key, model.block("beta"), model, position, ls, None, data, cache=lik
    )
    args = (_t(beta), _t(lik), _t(ls), _t(position["mu"]),
            _t(position["log_tau"]), tdata.x, tdata.y, tdata.mask)
    plain = fused_rwmh_logistic_step_plain(*args, (_t(eps), _t(logu)))
    wrapped = fused_rwmh_logistic_step(*args, noise=(_t(eps), _t(logu)))
    assert 0.05 < float(plain[2].mean()) < 0.999
    for out in (plain, wrapped):
        np.testing.assert_allclose(out[2].numpy(), _np(ralpha), **ALPHA_TOL)
        np.testing.assert_allclose(out[0].numpy(), _np(rb), **TOL)
        np.testing.assert_allclose(out[1].numpy(), _np(rlik), **TOL)


def _tmodel_pos(tdata, position):
    return (make_hier_logistic(tdata),
            {k: _t(v) for k, v in position.items()})


@pytest.mark.parametrize("kind", ["mala", "rwmh"])
def test_unfused_log_tau_update_matches_reference(kind):
    """The half-normal log_tau MH block (units = p, no cache): the port's
    update (closed-form gradient for MALA) vs the reference's (jax.vjp)."""
    data, model, position, tdata = _setup(dense=False)
    C, p = position["log_tau"].shape
    ls = jnp.asarray(np.log(np.linspace(0.1, 0.6, C * p, dtype=np.float32))
                     .reshape(C, p))
    key = jax.random.key(9)
    jfn = {"mala": j_mala_update, "rwmh": j_rwmh_update}[kind]
    rv, ralpha, _ = jfn(key, model.block("log_tau"), model, position, ls,
                        None, data)
    eps, logu = _noise(key, (C, p))
    tmodel, tpos = _tmodel_pos(tdata, position)
    rng = ReplayRNG([_np(eps), _np(logu)])
    tfn = {"mala": mala_update, "rwmh": rwmh_update}[kind]
    nv, alpha, ncache = tfn(rng, tmodel.block("log_tau"), tmodel, tpos,
                            _t(ls), tdata)
    assert rng.remaining == 0 and ncache is None
    np.testing.assert_allclose(alpha.numpy(), _np(ralpha), **ALPHA_TOL)
    np.testing.assert_allclose(nv.numpy(), _np(rv), **TOL)
    assert 0.05 < float(alpha.mean()) < 0.999


def test_log_tau_closed_form_gradient_matches_autograd():
    data, model, position, tdata = _setup(dense=False)
    tmodel, tpos = _tmodel_pos(tdata, position)
    lt = tpos["log_tau"]
    val, grad = tmodel.cond_value_and_grad("log_tau", lt, tpos, tdata)
    plain = dataclasses.replace(tmodel, cond_value_and_grad=None)
    aval, agrad = tmala.cond_value_and_grad(plain, "log_tau", lt, tpos,
                                            tdata)
    np.testing.assert_allclose(val.numpy(), aval.numpy(), rtol=1e-6,
                               atol=1e-3)
    np.testing.assert_allclose(grad.numpy(), agrad.numpy(), rtol=1e-5,
                               atol=1e-3)
    jval = model.cond_logdensity("log_tau", position["log_tau"], position,
                                 data)
    np.testing.assert_allclose(val.numpy(), _np(jval), rtol=1e-5, atol=1e-3)
    # outside the guard the conditional is -inf and a proposal there
    # rejects with alpha 0 (no inf - inf)
    far = lt.clone()
    far[0, 0] = 13.0
    v_far, g_far = tmodel.cond_value_and_grad("log_tau", far, tpos, tdata)
    assert float(v_far[0, 0]) == -np.inf and not torch.isnan(g_far).any()


def test_robbins_monro_matches_reference():
    r = np.random.default_rng(0)
    ls = r.standard_normal((5, 7)).astype(np.float32) * 4
    ls[0, 0], ls[0, 1] = 7.99, -11.99
    alpha = r.random((5, 7)).astype(np.float32)
    alpha[0, 0], alpha[0, 1] = 1.0, 0.0
    for t in (0, 3, 1499):
        out = adapt.adapt_log_scale(torch.as_tensor(ls),
                                    torch.as_tensor(alpha), t, 0.574,
                                    KernelConfig())
        ref = j_adapt(jnp.asarray(ls), jnp.asarray(alpha), jnp.int32(t),
                      0.574, JKernelConfig())
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6,
                                   atol=1e-6)
    assert float(out.max()) <= 8.0 and float(out.min()) >= -12.0
