"""The port's fused Newton-MH step (plain version, which the CUDA wrapper
runs for CPU tensors) vs the reference, on the same data, state and noise.

References: nestmc's fused_newton_logistic_step in interpret mode with
external noise, and the unfused kernels/newton.py newton_update (the
contract of tests/test_newton_fused.py), refresh and frozen, dense and
masked, with and without the streaming R-hat fold. Tolerances as
tests/test_newton_fused.py: alpha rtol 2e-3 / atol 2e-4; beta, v, g, h
atol 2e-4. The frozen step returns the carried h object itself.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.diagnostics import fold_rhat_scalars as j_fold_scalars
from nestmc.kernels.newton import newton_update as j_newton_update
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc.models import make_hier_logistic as j_make, synth_logistic
from nestmc.ops.pallas.newton_accept import fused_newton_logistic_step as j_step
from nestmc_torch.data import from_numpy
from nestmc_torch.diagnostics import fold_rhat_scalars
from nestmc_torch.kernels.newton import newton_update
from nestmc_torch.models import make_hier_logistic
from nestmc_torch.ops.cuda.newton_accept import (
    fused_newton_logistic_step,
    fused_newton_logistic_step_plain,
)
from nestmc_torch.rng import ReplayRNG

ALPHA_TOL = dict(rtol=2e-3, atol=2e-4)
TOL = dict(rtol=0, atol=2e-4)


def _np(a):
    return np.array(a, np.float32)


def _setup(dense, C=8, G=13, n=9, p=3):
    data, _ = synth_logistic(jax.random.key(17), G=G, n=n, p=p)
    if not dense:
        mask = np.array(data.mask)
        mask[0, n - 3:] = 0.0
        mask[5, n - 1:] = 0.0
        data = dataclasses.replace(
            data, mask=jnp.asarray(mask), y=data.y * jnp.asarray(mask)
        )
    model = j_make(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=C, log_every_segment=False),
    )
    state = j_init_state(model, cfg, jax.random.key(1), data)
    tdata = from_numpy(data.x, data.y, data.mask, device="cpu")
    return data, model, state, tdata


def _noise(key, C, G, p):
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, (C, G, p), jnp.float32)
    logu = jnp.log(jax.random.uniform(
        k_u, (C, G), jnp.float32, minval=jnp.finfo(jnp.float32).tiny
    ))
    return eps, logu


def _t(a):
    return torch.as_tensor(_np(a))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_fused_step_matches_reference(dense, frozen, fold):
    data, model, state, tdata = _setup(dense)
    beta = state.position["beta"]
    C, G, p = beta.shape
    key = jax.random.key(42 + frozen)
    eps, logu = _noise(key, C, G, p)
    c = state.cache["beta"]
    ls = state.log_scale["beta"]
    mu, lt = state.position["mu"], state.position["log_tau"]
    r = np.random.default_rng(5)
    fmean = r.standard_normal((2, G, p, C)).astype(np.float32)
    fm2 = r.random((2, G, p, C)).astype(np.float32)
    count = np.array([4.0, 0.0], np.float32)
    jfold = tfold = None
    if fold:
        jfold = (jnp.asarray(fmean), jnp.asarray(fm2),
                 j_fold_scalars(jnp.asarray(count), jnp.int32(4), 6))
        tfold = (_t(fmean), _t(fm2), fold_rhat_scalars(count, 4, 6))
        np.testing.assert_array_equal(_np(jfold[2]), tfold[2].numpy())

    ref = j_step(
        key, beta, c["v"], c["g"], c["h"], ls, mu, lt,
        data.x, data.y, data.mask, interpret=True, noise=(eps, logu),
        dense=dense, frozen=frozen, rhat_fold=jfold,
    )
    th = _t(c["h"])
    args = (_t(beta), _t(c["v"]), _t(c["g"]), th, _t(ls), _t(mu), _t(lt),
            tdata.x, tdata.y, tdata.mask)
    plain = fused_newton_logistic_step_plain(
        *args, (_t(eps), _t(logu)), frozen=frozen, rhat_fold=tfold,
    )
    wrapped = fused_newton_logistic_step(
        *args, noise=(_t(eps), _t(logu)), frozen=frozen, rhat_fold=tfold,
    )
    assert len(plain) == len(ref) == len(wrapped) == (7 if fold else 5)
    for out in (plain, wrapped):
        np.testing.assert_allclose(out[4].numpy(), _np(ref[4]), **ALPHA_TOL)
        for i in (0, 1, 2, 3):
            np.testing.assert_allclose(out[i].numpy(), _np(ref[i]), **TOL)
        for i in range(5, len(out)):
            np.testing.assert_allclose(out[i].numpy(), _np(ref[i]),
                                       rtol=1e-5, atol=1e-5)
        if frozen:
            assert out[3] is th

    # the unfused reference update with the same noise
    rb, ralpha, rcache = j_newton_update(
        key, model.block("beta"), model, state.position, ls, None, data,
        cache=c, frozen=frozen,
    )
    np.testing.assert_allclose(plain[4].numpy(), _np(ralpha), **ALPHA_TOL)
    for a, b in zip(plain[:4], (rb, rcache["v"], rcache["g"], rcache["h"])):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


@pytest.mark.parametrize("frozen", [False, True])
def test_unfused_newton_update_matches_reference(frozen):
    data, model, state, tdata = _setup(dense=False)
    beta = state.position["beta"]
    C, G, p = beta.shape
    key = jax.random.key(7)
    eps, logu = _noise(key, C, G, p)
    c = state.cache["beta"]
    ls = state.log_scale["beta"]
    rb, ralpha, rcache = j_newton_update(
        key, model.block("beta"), model, state.position, ls, None, data,
        cache=c, frozen=frozen,
    )
    tmodel = make_hier_logistic(tdata, tau_prior="invgamma")
    tpos = {k: _t(v) for k, v in state.position.items()}
    tcache = {k: _t(v) for k, v in c.items()}
    rng = ReplayRNG([_np(eps), _np(logu)])
    nb, alpha, ncache = newton_update(
        rng, tmodel.block("beta"), tmodel, tpos, _t(ls), tdata,
        cache=tcache, frozen=frozen,
    )
    assert rng.remaining == 0
    np.testing.assert_allclose(alpha.numpy(), _np(ralpha), **ALPHA_TOL)
    np.testing.assert_allclose(nb.numpy(), _np(rb), **TOL)
    for k in ("v", "g", "h"):
        np.testing.assert_allclose(ncache[k].numpy(), _np(rcache[k]), **TOL)
    if frozen:
        assert ncache["h"] is tcache["h"]


def test_nan_proposal_rejects():
    """A non-PD carried metric gives NaN log alpha: alpha 0, state kept."""
    data, model, state, tdata = _setup(dense=True, C=2, G=3)
    C, G, p = state.position["beta"].shape
    c = state.cache["beta"]
    h = _np(c["h"]).copy()
    h[0, 0, 0] = -1e6                         # indefinite at cell (0, 0)
    eps, logu = _noise(jax.random.key(3), C, G, p)
    out = fused_newton_logistic_step_plain(
        _t(state.position["beta"]), _t(c["v"]), _t(c["g"]),
        torch.as_tensor(h), _t(state.log_scale["beta"]),
        _t(state.position["mu"]), _t(state.position["log_tau"]),
        tdata.x, tdata.y, tdata.mask, (_t(eps), _t(logu)),
    )
    assert float(out[4][0, 0]) == 0.0
    np.testing.assert_array_equal(
        out[0][0, 0].numpy(), _np(state.position["beta"])[0, 0]
    )
