"""The port's Poisson obs passes and fused subject steps vs the reference,
on the same data, state and noise.

- The three obs passes (their wrappers run the plain versions for CPU
  tensors) vs nestmc.ops.loglik and vs the Pallas kernels of
  nestmc/ops/pallas/loglik_poisson.py in interpret mode, dense and masked,
  p=2 and p=3: rtol 1e-5 / atol 1e-4 (loglik 1e-4 relative, as the sums
  include the lgamma constants).
- The fused RW, MALA and Newton steps' plain versions vs nestmc's fused
  Pallas steps (nestmc/ops/pallas/poisson_accept.py) in interpret mode with
  external noise and vs the unfused rwmh_update / mala_update /
  newton_update with the model's caches, on the masked data of
  tests/test_poisson_fused.py's _setup (Newton refresh and frozen). The
  tolerances are those of tests/test_poisson_fused.py: alpha rtol 2e-3 /
  atol 2e-4; beta atol 2e-4; the carried loglik rtol 1e-4 / atol 2e-4;
  gradient and Hessian rtol 1e-3 / atol 2e-4. A NaN or overflowing
  proposal rejects with alpha 0 (tests/test_mala_accept_fused.py:112).
- NestedData3's deterministic subject -> group sums vs segment_sum, with
  groups of unequal size.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.kernels.mala import mala_update as j_mala_update
from nestmc.kernels.newton import newton_update as j_newton_update
from nestmc.kernels.rwmh import rwmh_update as j_rwmh_update
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc.models import make_nested_poisson as j_make, synth_poisson3
from nestmc.ops import loglik as jl
from nestmc.ops.pallas import loglik_poisson as jpl
from nestmc.ops.pallas import poisson_accept as jpa
from nestmc_torch.data import from_numpy3
from nestmc_torch.ops import loglik as tl
from nestmc_torch.ops.cuda import loglik_poisson as tk
from nestmc_torch.ops.cuda import poisson_accept as tpa

OBS_TOL = dict(rtol=1e-5, atol=1e-4)
LIK_TOL = dict(rtol=1e-4, atol=2e-4)
ALPHA_TOL = dict(rtol=2e-3, atol=2e-4)
BETA_TOL = dict(rtol=0, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=2e-4)
TINY = jnp.finfo(jnp.float32).tiny


def _np(a):
    return np.array(a, np.float32)


def _t(a):
    return torch.as_tensor(_np(a))


def _tdata(data):
    return from_numpy3(data.x, data.y, data.mask, data.subject_group,
                       data.num_groups, device="cpu")


def _masked(data, n):
    mask = np.array(data.mask)
    mask[0, n - 3:] = 0.0
    mask[3, :2] = 0.0
    return dataclasses.replace(
        data, mask=jnp.asarray(mask), y=data.y * jnp.asarray(mask)
    )


def _setup(algorithm, C=8, G=5, spg=3, n=7, p=3, dense=False):
    """tests/test_poisson_fused.py's _setup: masked data, an invgamma
    model and the reference's initial state with its caches."""
    data, _ = synth_poisson3(jax.random.key(23), G=G, subjects_per_group=spg,
                             n=n, p=p)
    if not dense:
        data = _masked(data, n)
    model = j_make(data, tau_prior="invgamma", loglik_impl="jnp")
    cfg = SamplerConfig(kernel=KernelConfig(algorithm=algorithm),
                        run=RunConfig(chains=C, log_every_segment=False))
    state = j_init_state(model, cfg, jax.random.key(2), data)
    return data, model, state, _tdata(data)


def _noise(key, C, S, p):
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, (C, S, p), jnp.float32)
    logu = jnp.log(jax.random.uniform(k_u, (C, S), jnp.float32,
                                      minval=TINY))
    return eps, logu


def _bgs(state, data):
    return jnp.take(state.position["beta_g"], data.subject_group, axis=1)


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("dense", [False, True])
def test_obs_passes_match_reference(dense, p):
    data, _ = synth_poisson3(jax.random.key(31), G=6, subjects_per_group=3,
                             n=9, p=p)
    if not dense:
        data = _masked(data, 9)
    beta = 0.3 * jax.random.normal(jax.random.key(4),
                                   (5, data.num_subjects, p))
    tdata = _tdata(data)
    args = (_t(beta), tdata.x, tdata.y, tdata.mask)
    ref_v = jl.poisson_loglik_padded(beta, data.x, data.y, data.mask)
    ref = jl.poisson_logp_grad_hess_padded(beta, data.x, data.y, data.mask)
    pal_v = jpl.poisson_loglik_padded_pallas(beta, data.x, data.y, data.mask,
                                             interpret=True)
    pal_g = jpl.poisson_logp_grad_pallas(beta, data.x, data.y, data.mask,
                                         interpret=True)
    pal_h = jpl.poisson_logp_grad_hess_pallas(beta, data.x, data.y,
                                              data.mask, interpret=True)
    const = tl.poisson_const(tdata.y, tdata.mask)
    for c in (None, const):
        v = tk.poisson_loglik(*args, const=c)
        vg = tk.poisson_logp_grad(*args, const=c)
        vgh = tk.poisson_logp_grad_hess(*args, const=c)
        for out in (v, vg[0], vgh[0]):
            np.testing.assert_allclose(out.numpy(), _np(ref_v), **LIK_TOL)
            np.testing.assert_allclose(out.numpy(), _np(pal_v), **LIK_TOL)
        for out in (vg[1], vgh[1]):
            np.testing.assert_allclose(out.numpy(), _np(ref[1]), **OBS_TOL)
            np.testing.assert_allclose(out.numpy(), _np(pal_g[1]), **OBS_TOL)
        np.testing.assert_allclose(vgh[2].numpy(), _np(ref[2]), **OBS_TOL)
        np.testing.assert_allclose(vgh[2].numpy(), _np(pal_h[2]), **OBS_TOL)
        np.testing.assert_allclose(vg[0].numpy(), _np(pal_g[0]), **LIK_TOL)


@pytest.mark.parametrize("dense", [False, True])
def test_rwmh_step_matches_reference(dense):
    data, model, state, tdata = _setup("rwmh", dense=dense)
    beta = state.position["beta_s"]
    C, S, p = beta.shape
    key = jax.random.key(7)
    ls = state.log_scale["beta_s"]
    eps, logu = _noise(key, C, S, p)
    lik = state.cache["beta_s"]
    ref = jpa.fused_rwmh_poisson_step(
        key, beta, lik, ls, _bgs(state, data), state.position["log_tau_s"],
        data.x, data.y, data.mask, interpret=True, noise=(eps, logu),
        dense=dense,
    )
    rb, ralpha, rlik = j_rwmh_update(
        key, model.block("beta_s"), model, state.position, ls, None, data,
        cache=lik,
    )
    args = (_t(beta), _t(lik), _t(ls), _t(_bgs(state, data)),
            _t(state.position["log_tau_s"]), tdata.x, tdata.y, tdata.mask)
    plain = tpa.fused_rwmh_poisson_step_plain(*args, (_t(eps), _t(logu)))
    wrapped = tpa.fused_rwmh_poisson_step(*args, noise=(_t(eps), _t(logu)))
    assert 0.05 < float(plain[2].mean()) < 0.999
    for out in (plain, wrapped):
        for want in ((ref[0], ref[1], ref[2]), (rb, rlik, ralpha)):
            np.testing.assert_allclose(out[2].numpy(), _np(want[2]),
                                       **ALPHA_TOL)
            np.testing.assert_allclose(out[0].numpy(), _np(want[0]),
                                       **BETA_TOL)
            np.testing.assert_allclose(out[1].numpy(), _np(want[1]),
                                       **LIK_TOL)


@pytest.mark.parametrize("dense", [False, True])
def test_mala_step_matches_reference(dense):
    data, model, state, tdata = _setup("mala", dense=dense)
    beta = state.position["beta_s"]
    C, S, p = beta.shape
    key = jax.random.key(8)
    ls = state.log_scale["beta_s"]
    eps, logu = _noise(key, C, S, p)
    c = state.cache["beta_s"]
    ref = jpa.fused_mala_poisson_step(
        key, beta, c["v"], c["g"], ls, _bgs(state, data),
        state.position["log_tau_s"], data.x, data.y, data.mask,
        interpret=True, noise=(eps, logu), dense=dense,
    )
    rb, ralpha, rcache = j_mala_update(
        key, model.block("beta_s"), model, state.position, ls, None, data,
        cache=c,
    )
    args = (_t(beta), _t(c["v"]), _t(c["g"]), _t(ls), _t(_bgs(state, data)),
            _t(state.position["log_tau_s"]), tdata.x, tdata.y, tdata.mask)
    plain = tpa.fused_mala_poisson_step_plain(*args, (_t(eps), _t(logu)))
    wrapped = tpa.fused_mala_poisson_step(*args, noise=(_t(eps), _t(logu)))
    assert 0.05 < float(plain[3].mean()) < 0.999
    for out in (plain, wrapped):
        for want in (ref, (rb, rcache["v"], rcache["g"], ralpha)):
            np.testing.assert_allclose(out[3].numpy(), _np(want[3]),
                                       **ALPHA_TOL)
            np.testing.assert_allclose(out[0].numpy(), _np(want[0]),
                                       **BETA_TOL)
            np.testing.assert_allclose(out[1].numpy(), _np(want[1]),
                                       **LIK_TOL)
            np.testing.assert_allclose(out[2].numpy(), _np(want[2]),
                                       **GRAD_TOL)


@pytest.mark.parametrize("frozen", [False, True])
def test_newton_step_matches_reference(frozen):
    data, model, state, tdata = _setup("newton")
    beta = state.position["beta_s"]
    C, S, p = beta.shape
    key = jax.random.key(9)
    ls = state.log_scale["beta_s"]
    eps, logu = _noise(key, C, S, p)
    c = state.cache["beta_s"]
    ref = jpa.fused_newton_poisson_step(
        key, beta, c["v"], c["g"], c["h"], ls, _bgs(state, data),
        state.position["log_tau_s"], data.x, data.y, data.mask,
        interpret=True, noise=(eps, logu), frozen=frozen,
    )
    rb, ralpha, rcache = j_newton_update(
        key, model.block("beta_s"), model, state.position, ls, None, data,
        cache=c, frozen=frozen,
    )
    h = _t(c["h"])
    args = (_t(beta), _t(c["v"]), _t(c["g"]), h, _t(ls),
            _t(_bgs(state, data)), _t(state.position["log_tau_s"]),
            tdata.x, tdata.y, tdata.mask)
    plain = tpa.fused_newton_poisson_step_plain(*args, (_t(eps), _t(logu)),
                                                frozen=frozen)
    wrapped = tpa.fused_newton_poisson_step(*args, noise=(_t(eps), _t(logu)),
                                            frozen=frozen)
    assert 0.05 < float(plain[4].mean()) <= 1.0
    for out in (plain, wrapped):
        for want in (ref, (rb, rcache["v"], rcache["g"], rcache["h"],
                           ralpha)):
            np.testing.assert_allclose(out[4].numpy(), _np(want[4]),
                                       **ALPHA_TOL)
            np.testing.assert_allclose(out[0].numpy(), _np(want[0]),
                                       **BETA_TOL)
            np.testing.assert_allclose(out[1].numpy(), _np(want[1]),
                                       **LIK_TOL)
            np.testing.assert_allclose(out[2].numpy(), _np(want[2]),
                                       **GRAD_TOL)
            if not frozen:
                np.testing.assert_allclose(out[3].numpy(), _np(want[3]),
                                           **GRAD_TOL)
        if frozen:
            assert out[3] is h        # the frozen metric passes through


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton"])
@pytest.mark.parametrize("bad", [float("nan"), 80.0])
def test_nan_or_overflowing_proposal_rejects(algorithm, bad):
    """A NaN proposal, or one whose rate overflows (exp(80 * x) = inf),
    rejects every cell with alpha 0 and keeps the state and caches."""
    data, model, state, tdata = _setup(algorithm, dense=True)
    beta = _t(state.position["beta_s"])
    C, S, p = beta.shape
    eps = torch.full((C, S, p), bad)
    logu = torch.full((C, S), -1.0)
    ls = torch.zeros(C, S)
    bgs, lts = _t(_bgs(state, data)), _t(state.position["log_tau_s"])
    dat = (tdata.x, tdata.y, tdata.mask)
    c = state.cache["beta_s"]
    if algorithm == "rwmh":
        out = tpa.fused_rwmh_poisson_step_plain(
            beta, _t(c), ls, bgs, lts, *dat, (eps, logu))
        kept = (beta, _t(c))
    elif algorithm == "mala":
        out = tpa.fused_mala_poisson_step_plain(
            beta, _t(c["v"]), _t(c["g"]), ls, bgs, lts, *dat, (eps, logu))
        kept = (beta, _t(c["v"]), _t(c["g"]))
    else:
        out = tpa.fused_newton_poisson_step_plain(
            beta, _t(c["v"]), _t(c["g"]), _t(c["h"]), ls, bgs, lts, *dat,
            (eps, logu))
        kept = (beta, _t(c["v"]), _t(c["g"]), _t(c["h"]))
    np.testing.assert_array_equal(out[-1].numpy(), 0.0)
    for a, b in zip(out, kept):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_group_sums_are_segment_sums():
    """to_subjects and group_sum vs jnp.take and segment_sum, for groups
    of equal size (the reshape path) and of unequal size, one empty."""
    r = np.random.default_rng(0)
    for sg, G in ((np.repeat(np.arange(4), 3), 4),
                  (np.array([0, 0, 0, 1, 3, 3, 4, 4, 4, 4]), 5)):
        S = sg.size
        x = np.ones((S, 2, 2), np.float32)
        d = from_numpy3(x, x[..., 0], x[..., 0], sg, G, device="cpu")
        assert (d.members is None) == (G == 4)
        np.testing.assert_array_equal(d.subject_counts.numpy(),
                                      np.bincount(sg, minlength=G))
        a = r.standard_normal((3, S, 2)).astype(np.float32)
        want = jax.ops.segment_sum(jnp.swapaxes(a, 0, 1), sg,
                                   num_segments=G)
        np.testing.assert_allclose(d.group_sum(_t(a)).numpy(),
                                   _np(jnp.swapaxes(want, 0, 1)),
                                   rtol=1e-6, atol=1e-6)
        b = r.standard_normal((3, G, 2)).astype(np.float32)
        np.testing.assert_array_equal(d.to_subjects(_t(b)).numpy(),
                                      b[:, sg])
    with pytest.raises(ValueError, match="sorted"):
        from_numpy3(x, x[..., 0], x[..., 0], sg[::-1], G, device="cpu")
