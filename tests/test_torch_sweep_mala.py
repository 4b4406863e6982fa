"""The port's MALA and RW-MH sweeps vs nestmc's make_sweep, the
interweaving move's grad and RW modes one step at a time, the thinned
streamed R-hat, the presets and the default device.

The reference runs its unfused updates on the CPU (kernels/gibbs.py takes
the fused steps only on a TPU); the port's sweep runs its fused steps'
plain versions for CPU tensors, which equal those updates given the same
noise. The noise the reference draws from its key schedule (kernels/
gibbs.py fold_in per block, repeat and move; kernels/mala.py and rwmh.py
split per update; models/hier_logistic.py gibbs_mu and the move's k1/k2)
is recomputed here and fed to the port through ReplayRNG. Sweeps: rtol
1e-4 / atol 1e-3; one-step alpha of the move rtol 2e-3 / atol 2e-4; the
thinned R-hat and ESS rtol 1e-4.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc import diagnostics as jd
from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.kernels.gibbs import make_sweep as j_make_sweep
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc.models import make_hier_logistic as j_make, synth_logistic
import nestmc_torch
from nestmc_torch import config as tconfig
from nestmc_torch.bench import n_params
from nestmc_torch.data import from_numpy
from nestmc_torch.kernels.gibbs import (
    joint_move_target,
    make_sweep,
    rhat_fold_names,
)
from nestmc_torch.kernels.state import init_kernel_state, state_from_numpy
from nestmc_torch.models import make_hier_logistic
from nestmc_torch.models import synth_logistic as t_synth
from nestmc_torch.presets import get_preset
from nestmc_torch.rng import ReplayRNG

TOL = dict(rtol=1e-4, atol=1e-3)
ALPHA_TOL = dict(rtol=2e-3, atol=2e-4)
C, G, N, P = 6, 12, 10, 3
TINY = jnp.finfo(jnp.float32).tiny


def _np(a):
    return np.array(a, np.float32)


def _cfgs(algorithm):
    kernel = dict(algorithm=algorithm)
    run = dict(chains=C, log_every_segment=False)
    return (
        SamplerConfig(kernel=KernelConfig(**kernel), run=RunConfig(**run)),
        tconfig.SamplerConfig(
            kernel=tconfig.KernelConfig(**kernel),
            run=tconfig.RunConfig(**run),
        ),
    )


def _setup(algorithm):
    data, _ = synth_logistic(jax.random.key(11), G=G, n=N, p=P)
    jmodel = j_make(data)
    jcfg, tcfg = _cfgs(algorithm)
    jstate = j_init_state(jmodel, jcfg, jax.random.key(2), data)
    tdata = from_numpy(data.x, data.y, data.mask, device="cpu")
    return data, jmodel, jcfg, jstate, tdata, make_hier_logistic(tdata), tcfg


def _logu(key, shape):
    return jnp.log(jax.random.uniform(key, shape, jnp.float32, minval=TINY))


def _replay_noise(state, algorithm):
    """The noise one reference sweep draws, in the order the port asks:
    beta's update, mu's draw, the 4 log_tau repeats, the move."""
    _, key_sweep = jax.random.split(state.key)
    out = []
    k_eps, k_u = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(key_sweep, 0), 0))
    out += [jax.random.normal(k_eps, (C, G, P)), _logu(k_u, (C, G))]
    out.append(jax.random.normal(jax.random.fold_in(key_sweep, 1), (C, P)))
    for r in range(4):
        k_eps, k_u = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(key_sweep, 2), r))
        out += [jax.random.normal(k_eps, (C, P)), _logu(k_u, (C, P))]
    k1, k2 = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(key_sweep, 1000), 0))
    out += [jax.random.normal(k1, (C, 2 * P) if algorithm == "mala"
                              else (C, P)),
            _logu(k2, (C,))]
    return [_np(a) for a in out]


def _cache_np(c):
    if c is None:
        return None
    if isinstance(c, dict):
        return {k: _np(v) for k, v in c.items()}
    return _np(c)


def _port_state(jstate):
    return state_from_numpy(
        {k: _np(v) for k, v in jstate.position.items()},
        {k: _np(v) for k, v in jstate.log_scale.items()},
        {k: _np(v) for k, v in jstate.accept_sum.items()},
        {k: _cache_np(c) for k, c in jstate.cache.items()},
        t=int(jstate.t), device="cpu",
    )


def _compare(tstate, jstate):
    for field in ("position", "log_scale", "accept_sum"):
        for k, v in getattr(jstate, field).items():
            np.testing.assert_allclose(
                getattr(tstate, field)[k].numpy(), _np(v), **TOL,
                err_msg=f"{field} {k}",
            )
    jc, tc = jstate.cache["beta"], tstate.cache["beta"]
    if isinstance(jc, dict):
        assert set(tc) == set(jc)
        for kk in jc:
            np.testing.assert_allclose(tc[kk].numpy(), _np(jc[kk]), **TOL,
                                       err_msg=kk)
    else:
        np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    assert tstate.t == int(jstate.t)


@pytest.mark.parametrize("algorithm", ["mala", "rwmh"])
def test_init_state_matches(algorithm):
    data, jmodel, jcfg, jstate, tdata, tmodel, tcfg = _setup(algorithm)
    pos = {k: torch.as_tensor(_np(v)) for k, v in jstate.position.items()}
    tstate = init_kernel_state(tmodel, tcfg, None, tdata, position=pos)
    _compare(tstate, jstate)
    assert tstate.cache["mu"] is None and tstate.cache["log_tau"] is None


@pytest.mark.parametrize("algorithm", ["mala", "rwmh"])
def test_warmup_then_sampling_sweep_match(algorithm):
    data, jmodel, jcfg, jstate, tdata, tmodel, tcfg = _setup(algorithm)
    jsweep = j_make_sweep(jmodel, jcfg)
    tsweep = make_sweep(tmodel, tcfg)
    assert joint_move_target(tmodel, "asis_tau", tcfg) == (
        0.574 if algorithm == "mala" else 0.234)
    state = jstate
    for adapt in (True, True, False):
        rng = ReplayRNG(_replay_noise(state, algorithm))
        tstate = tsweep(_port_state(state), tdata, adapt, rng)
        state = jsweep(state, data, adapt=adapt)
        assert rng.remaining == 0
        _compare(tstate, state)
    # adaptation moved every MH scale in warmup, and nothing in sampling
    t0 = _port_state(jstate)
    for k in ("beta", "log_tau", "asis_tau"):
        assert not torch.equal(tstate.log_scale[k], t0.log_scale[k]), k


def test_rhat_fold_names_follow_thinning():
    _, _, _, _, tdata, tmodel, tcfg = _setup("mala")
    assert rhat_fold_names(tmodel, tcfg) == ("beta",)
    thin = tconfig.SamplerConfig(
        kernel=tcfg.kernel,
        run=tconfig.RunConfig(chains=C, full_rhat_thin=4),
    )
    assert rhat_fold_names(tmodel, thin) == ()


@pytest.mark.parametrize("mode", ["grad", "rw"])
def test_asis_move_one_step_matches_reference(mode):
    """One step of the interweaving move in grad (MALA cache) and RW
    (loglik cache) mode, as tests/test_asis_grad.py drives the reference."""
    data, _ = synth_logistic(jax.random.key(3), G=20, n=10, p=3)
    jmodel = j_make(data, loglik_impl="jnp")
    Cm = 8
    position = jmodel.init_state(jax.random.key(4), data, Cm)
    v, g = jmodel.cond_cached_grad["beta"][0](position["beta"], data)
    cache = {"beta": {"v": v, "g": g} if mode == "grad" else v}
    scale = jnp.full((Cm, 1), 0.4 if mode == "grad" else 0.05, jnp.float32)
    key = jax.random.key(11)
    jup, jcache, jalpha = jmodel.joint_moves["asis_tau"](
        key, position, cache, scale, data)
    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, (Cm, 6) if mode == "grad" else (Cm, 3))
    rng = ReplayRNG([_np(eps), _np(_logu(k2, (Cm,)))])
    tdata = from_numpy(data.x, data.y, data.mask, device="cpu")
    tmodel = make_hier_logistic(tdata)
    tpos = {k: torch.as_tensor(_np(v)) for k, v in position.items()}
    tcache = {"beta": ({k: torch.as_tensor(_np(x))
                        for k, x in cache["beta"].items()}
                       if mode == "grad" else torch.as_tensor(_np(v)))}
    tup, tc, talpha = tmodel.joint_moves["asis_tau"](
        rng, tpos, tcache, torch.as_tensor(_np(scale)), tdata)
    assert rng.remaining == 0
    assert 0.02 < float(talpha.mean()) < 0.999
    np.testing.assert_allclose(talpha.numpy(), _np(jalpha), **ALPHA_TOL)
    assert set(tup) == set(jup)
    for k in jup:
        np.testing.assert_allclose(tup[k].numpy(), _np(jup[k]), **TOL)
    if mode == "grad":
        for k in ("v", "g"):
            np.testing.assert_allclose(tc["beta"][k].numpy(),
                                       _np(jcache["beta"][k]), **TOL)
    else:
        np.testing.assert_allclose(tc["beta"].numpy(),
                                   _np(jcache["beta"]), **TOL)


@pytest.mark.parametrize("algorithm,thin,draws",
                         [("mala", 4, 42), ("mala", 1, 40), ("rwmh", 4, 41)])
def test_thinned_streaming_rhat_matches_reference(algorithm, thin, draws):
    """The engine's streamed R-hat and ESS over every parameter equal
    nestmc.diagnostics on the collected draws thinned the same way (every
    thin-th draw from 0); at thin 1 the MALA step folds them in-sweep."""
    tdata, _ = t_synth(7, G=5, n=8, p=2, device="cpu")
    post = nestmc_torch.sample(
        make_hier_logistic(tdata), tdata,
        tconfig.SamplerConfig(
            kernel=tconfig.KernelConfig(algorithm=algorithm),
            run=tconfig.RunConfig(chains=8, warmup=10, draws=draws, seed=1,
                                  full_rhat=True, full_rhat_thin=thin,
                                  log_every_segment=False),
        ),
    )
    for name, x in post.draws.items():
        xt = jnp.asarray(x[:, ::thin].numpy())
        np.testing.assert_allclose(post.full_rhat[name].numpy(),
                                   _np(jd.split_rhat(xt)), rtol=1e-4,
                                   err_msg=name)
        e, lb = jd.cross_chain_ess(xt)
        np.testing.assert_allclose(post.full_ess[name]["ess"].numpy(),
                                   _np(e), rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(post.full_ess[name]["ess_lb"].numpy(),
                                   _np(lb), rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("name,shape,chains,n_par,algorithm", [
    ("judged", (1000, 50, 4), 1024, 4008, "newton"),
    ("mala-100k", (100_000, 20, 3), 512, 300_006, "mala"),
    ("hier-logistic-100-rw", (100, 50, 4), 64, 408, "rwmh"),
])
def test_presets_at_full_width(name, shape, chains, n_par, algorithm):
    model, data, cfg = get_preset(name, device="cpu")
    assert tuple(data.x.shape) == shape
    assert (cfg.run.chains, cfg.run.warmup, cfg.run.draws) == (
        chains, 1500, 4096)
    assert cfg.kernel.algorithm == algorithm
    assert n_params(model) == n_par
    tconfig.validate(cfg)


def test_entry_points_default_to_the_card(monkeypatch):
    """synth_logistic, from_numpy and state_from_numpy ask for CUDA unless
    told otherwise; without a card they raise instead of falling back."""
    for fn in (t_synth, from_numpy, state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_synth(0, G=3, n=4, p=2)
    x = np.zeros((3, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy(x, x[..., 0], x[..., 0] + 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy({"mu": x[0]}, {}, {}, {})


def test_validate_takes_the_three_algorithms():
    for algorithm in ("rwmh", "mala", "newton"):
        tconfig.validate(tconfig.SamplerConfig(
            kernel=tconfig.KernelConfig(algorithm=algorithm)))
    with pytest.raises(ValueError):
        tconfig.validate(tconfig.SamplerConfig(
            kernel=tconfig.KernelConfig(algorithm="hmc")))
    with pytest.raises(ValueError):
        tconfig.validate(tconfig.SamplerConfig(
            run=tconfig.RunConfig(full_rhat_thin=0)))
    with pytest.raises(NotImplementedError):
        tconfig.validate(tconfig.SamplerConfig(
            run=tconfig.RunConfig(thin=2)))
