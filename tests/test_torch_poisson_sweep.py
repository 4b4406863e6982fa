"""The port's nested Poisson model vs nestmc's, one sweep and one move at a
time, on the same data, state and noise; the config-3 presets; the
default device of the new entry points.

The reference runs its unfused updates on the CPU (kernels/gibbs.py takes
the fused steps only on a TPU); the port's sweep runs its fused steps'
plain versions for CPU tensors, which equal those updates given the same
noise (tests/test_torch_poisson_ops.py). The noise the reference draws
from its key schedule (kernels/gibbs.py: fold_in per block, repeat and
move; kernels/{rwmh,mala,newton}.py: split per update; the Gibbs draws'
normal and gamma; each interweaving move's k1/k2) is recomputed here and
fed to the port through ReplayRNG. Each sweep starts from the reference's
own KernelState carried across with state_from_numpy. Sweeps: rtol 1e-4
/ atol 1e-3; one-step alpha of the moves rtol 2e-3 / atol 2e-4.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.kernels.gibbs import make_sweep as j_make_sweep
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc.models import make_nested_poisson as j_make, synth_poisson3
from nestmc_torch import config as tconfig
from nestmc_torch.bench import n_params
from nestmc_torch.data import from_numpy3
from nestmc_torch.kernels.gibbs import joint_move_target, make_sweep
from nestmc_torch.kernels.state import init_kernel_state, state_from_numpy
from nestmc_torch.models import make_nested_poisson
from nestmc_torch.models import synth_poisson3 as t_synth
from nestmc_torch.presets import get_preset
from nestmc_torch.rng import ReplayRNG

TOL = dict(rtol=1e-4, atol=1e-3)
ALPHA_TOL = dict(rtol=2e-3, atol=2e-4)
C, G, SPG, N, P = 6, 4, 3, 8, 3
S = G * SPG
TINY = jnp.finfo(jnp.float32).tiny
BLOCKS = ("beta_s", "beta_g", "mu", "log_tau_g", "log_tau_s")


def _np(a):
    return np.array(a, np.float32)


def _t(a):
    return torch.as_tensor(_np(a))


def _cfgs(algorithm):
    kernel = dict(algorithm=algorithm)
    run = dict(chains=C, log_every_segment=False)
    return (
        SamplerConfig(kernel=KernelConfig(**kernel), run=RunConfig(**run)),
        tconfig.SamplerConfig(kernel=tconfig.KernelConfig(**kernel),
                              run=tconfig.RunConfig(**run)),
    )


def _data():
    data, _ = synth_poisson3(jax.random.key(11), G=G, subjects_per_group=SPG,
                             n=N, p=P)
    return data, from_numpy3(data.x, data.y, data.mask, data.subject_group,
                             G, device="cpu")


def _setup(algorithm, prior):
    data, tdata = _data()
    jmodel = j_make(data, tau_prior=prior, loglik_impl="jnp")
    jcfg, tcfg = _cfgs(algorithm)
    jstate = j_init_state(jmodel, jcfg, jax.random.key(2), data)
    tmodel = make_nested_poisson(tdata, tau_prior=prior)
    return data, jmodel, jcfg, jstate, tdata, tmodel, tcfg


def _logu(key, shape):
    return jnp.log(jax.random.uniform(key, shape, jnp.float32, minval=TINY))


def _replay_noise(state, prior):
    """The noise one reference sweep draws, in the order the port asks:
    beta_s's update, beta_g's and mu's draws, log_tau_g and log_tau_s
    (conjugate gamma draws, or 4 MH repeats each), then the 4 tau_g and 2
    tau_s interweaving moves."""
    _, ks = jax.random.split(state.key)
    out = []
    k_eps, k_u = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(ks, 0), 0))
    out += [jax.random.normal(k_eps, (C, S, P)), _logu(k_u, (C, S))]
    out.append(jax.random.normal(jax.random.fold_in(ks, 1), (C, G, P)))
    out.append(jax.random.normal(jax.random.fold_in(ks, 2), (C, P)))
    for i, units in ((3, G), (4, S)):
        kb = jax.random.fold_in(ks, i)
        if prior == "invgamma":
            out.append(jax.random.gamma(kb, 2.0 + 0.5 * units, shape=(C, P),
                                        dtype=jnp.float32))
            continue
        for r in range(4):
            k_eps, k_u = jax.random.split(jax.random.fold_in(kb, r))
            out += [jax.random.normal(k_eps, (C, P)), _logu(k_u, (C, P))]
    for j, reps in ((0, 4), (1, 2)):
        km = jax.random.fold_in(ks, 1000 + j)
        for r in range(reps):
            k1, k2 = jax.random.split(jax.random.fold_in(km, r))
            out += [jax.random.normal(k1, (C, P)), _logu(k2, (C,))]
    return [_np(a) for a in out]


def _cache_np(c):
    if c is None:
        return None
    if isinstance(c, dict):
        return {k: _np(v) for k, v in c.items()}
    return _np(c)


def _port_state(jstate):
    """The reference's KernelState carried across (state_from_numpy)."""
    return state_from_numpy(
        {k: _np(v) for k, v in jstate.position.items()},
        {k: _np(v) for k, v in jstate.log_scale.items()},
        {k: _np(v) for k, v in jstate.accept_sum.items()},
        {k: _cache_np(c) for k, c in jstate.cache.items()},
        t=int(jstate.t), device="cpu",
    )


def _compare(tstate, jstate):
    for field in ("position", "log_scale", "accept_sum"):
        jf, tf = getattr(jstate, field), getattr(tstate, field)
        assert set(tf) == set(jf), field
        for k, v in jf.items():
            np.testing.assert_allclose(tf[k].numpy(), _np(v), **TOL,
                                       err_msg=f"{field} {k}")
    for name in BLOCKS:
        jc, tc = jstate.cache[name], tstate.cache[name]
        if jc is None:
            assert tc is None, name
        elif isinstance(jc, dict):
            assert set(tc) == set(jc)
            for kk in jc:
                np.testing.assert_allclose(tc[kk].numpy(), _np(jc[kk]),
                                           **TOL, err_msg=kk)
        else:
            np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    assert tstate.t == int(jstate.t)


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton"])
def test_init_state_matches(algorithm):
    data, jmodel, jcfg, jstate, tdata, tmodel, tcfg = _setup(algorithm,
                                                             "invgamma")
    pos = {k: _t(v) for k, v in jstate.position.items()}
    _compare(init_kernel_state(tmodel, tcfg, None, tdata, position=pos),
             jstate)


@pytest.mark.parametrize("algorithm,prior", [
    ("rwmh", "invgamma"), ("mala", "invgamma"), ("newton", "invgamma"),
    ("rwmh", "halfnormal"), ("mala", "halfnormal"),
])
def test_jax_state_carried_across_gives_the_same_sweeps(algorithm, prior):
    """Two warmup sweeps and one sampling sweep (Newton: refreshed, then
    frozen), each from the reference's state carried across."""
    data, jmodel, jcfg, jstate, tdata, tmodel, tcfg = _setup(algorithm,
                                                             prior)
    jsweep = j_make_sweep(jmodel, jcfg)
    tsweep = make_sweep(tmodel, tcfg)
    state = jstate
    for adapt in (True, True, False):
        rng = ReplayRNG(_replay_noise(state, prior))
        tstate = tsweep(_port_state(state), tdata, adapt, rng)
        state = jsweep(state, data, adapt=adapt)
        assert rng.remaining == 0
        _compare(tstate, state)
    assert joint_move_target(tmodel, "asis_tau_g", tcfg) is None
    assert joint_move_target(tmodel, "asis_tau_s", tcfg) == {
        "rwmh": 0.234, "mala": 0.574, "newton": None}[algorithm]


def _move_inputs(mode):
    data, tdata = _data()
    jmodel = j_make(data, tau_prior="invgamma", loglik_impl="jnp")
    position = jmodel.init_state(jax.random.key(4), data, C)
    bs = position["beta_s"]
    if mode == "rw":
        cache = {"beta_s": jmodel.cond_cached["beta_s"][0](bs, data)}
    elif mode == "grad":
        v, g = jmodel.cond_cached_grad["beta_s"][0](bs, data)
        cache = {"beta_s": {"v": v, "g": g}}
    else:
        v, g, h = jmodel.cond_cached_newton["beta_s"][0](bs, data)
        cache = {"beta_s": {"v": v, "g": g, "h": h}}
    return data, tdata, jmodel, position, cache


def _tcache(c):
    c = c["beta_s"]
    if isinstance(c, dict):
        return {"beta_s": {k: _t(v) for k, v in c.items()}}
    return {"beta_s": _t(c)}


@pytest.mark.parametrize("move,mode", [
    ("asis_tau_g", "rw"), ("asis_tau_s", "rw"), ("asis_tau_s", "grad"),
    ("asis_tau_s", "newton"), ("asis_tau_s", "newton-frozen"),
])
def test_interweaving_move_one_step_matches_reference(move, mode):
    data, tdata, jmodel, position, cache = _move_inputs(mode)
    frozen = mode == "newton-frozen"
    scale = jnp.full((C, 1), {"rw": 0.02, "grad": 0.3}.get(mode, 1.0),
                     jnp.float32)
    key = jax.random.key(13)
    kw = {"frozen": frozen} if move == "asis_tau_s" else {}
    jup, jcache, jalpha = jmodel.joint_moves[move](key, position, cache,
                                                   scale, data, **kw)
    k1, k2 = jax.random.split(key)
    rng = ReplayRNG([_np(jax.random.normal(k1, (C, P))),
                     _np(_logu(k2, (C,)))])
    tmodel = make_nested_poisson(tdata, tau_prior="invgamma")
    tcache = _tcache(cache)
    tup, tc, talpha = tmodel.joint_moves[move](
        rng, {k: _t(v) for k, v in position.items()}, tcache, _t(scale),
        tdata, **kw)
    assert rng.remaining == 0
    assert 0.02 < float(talpha.mean()) < 0.999
    np.testing.assert_allclose(talpha.numpy(), _np(jalpha), **ALPHA_TOL)
    assert set(tup) == set(jup) and set(tc) == set(jcache)
    for k in jup:
        np.testing.assert_allclose(tup[k].numpy(), _np(jup[k]), **TOL)
    if tc:
        jc, c = jcache["beta_s"], tc["beta_s"]
        if isinstance(jc, dict):
            for k in jc:
                np.testing.assert_allclose(c[k].numpy(), _np(jc[k]), **TOL)
            if frozen:
                assert c["h"] is tcache["beta_s"]["h"]
        else:
            np.testing.assert_allclose(c.numpy(), _np(jc), **TOL)


@pytest.mark.parametrize("prior", ["invgamma", "halfnormal"])
def test_conditionals_and_joint_match_reference(prior):
    data, tdata = _data()
    jmodel = j_make(data, tau_prior=prior, loglik_impl="jnp")
    tmodel = make_nested_poisson(tdata, tau_prior=prior)
    position = jmodel.init_state(jax.random.key(5), data, C)
    tpos = {k: _t(v) for k, v in position.items()}
    for name in BLOCKS:
        np.testing.assert_allclose(
            tmodel.cond_logdensity(name, tpos[name], tpos, tdata).numpy(),
            _np(jmodel.cond_logdensity(name, position[name], position,
                                       data)),
            rtol=1e-5, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(
        tmodel.joint_logdensity(tpos, tdata).numpy(),
        _np(jmodel.joint_logdensity(position, data)), rtol=1e-5)
    assert tmodel.joint_move_init_scale == pytest.approx(
        jmodel.joint_move_init_scale)
    assert tmodel.joint_move_repeats == jmodel.joint_move_repeats
    assert set(tmodel.gibbs_draws) == set(jmodel.gibbs_draws)


@pytest.mark.parametrize("name,algorithm", [
    ("nested-poisson-1k", "rwmh"), ("nested-poisson-1k-mala", "mala"),
    ("nested-poisson-1k-newton", "newton"),
])
def test_config3_presets_at_full_width(name, algorithm):
    model, data, cfg = get_preset(name, device="cpu")
    assert tuple(data.x.shape) == (4000, 10, 3)
    assert data.num_groups == 1000 and data.members is None
    assert (cfg.run.chains, cfg.run.warmup, cfg.run.draws) == (
        512, 1000, 16384)
    assert cfg.kernel.algorithm == algorithm and cfg.run.full_rhat
    assert n_params(model) == 15_009
    assert set(model.gibbs_draws) == set(BLOCKS[1:])
    tconfig.validate(cfg)


def test_new_entry_points_default_to_the_card(monkeypatch):
    """synth_poisson3 and from_numpy3 ask for CUDA unless told otherwise;
    without a card they raise instead of falling back."""
    for fn in (t_synth, from_numpy3):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_synth(0, G=3, subjects_per_group=2, n=4, p=2)
    x = np.zeros((4, 3, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy3(x, x[..., 0], x[..., 0] + 1.0, np.array([0, 0, 1, 1]), 2)
