"""One warmup sweep and one sampling sweep of the port vs nestmc's
make_sweep, from the same state, with the reference's noise replayed.

nestmc runs its unfused Newton update on the CPU (kernels/gibbs.py takes
the fused step only on a TPU); the port's sweep runs its fused step's
plain version for CPU tensors, which equals that update. The noise the
reference draws from its key schedule (kernels/gibbs.py fold_in/split per
block and move; kernels/newton.py; models/hier_logistic.py gibbs_mu,
gibbs_log_tau and the ASIS move's shared key k1) is recomputed here and
fed to the port through nestmc_torch.rng.ReplayRNG. Tolerance rtol 1e-4,
atol 1e-3 (the interweaving metric sums about G terms). The initial
cache is checked at the obs-pass tolerance (rtol 1e-5, atol 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.diagnostics import fold_rhat_init as j_fold_init
from nestmc.diagnostics import fold_rhat_scalars as j_fold_scalars
from nestmc.kernels.gibbs import make_sweep as j_make_sweep
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc.models import make_hier_logistic as j_make, synth_logistic
from nestmc_torch import config as tconfig
from nestmc_torch.data import from_numpy
from nestmc_torch.diagnostics import fold_rhat_scalars
from nestmc_torch.kernels.gibbs import make_sweep, rhat_fold_names
from nestmc_torch.kernels.state import init_kernel_state, state_from_numpy
from nestmc_torch.models import make_hier_logistic
from nestmc_torch.rng import ReplayRNG, SweepRNG

TOL = dict(rtol=1e-4, atol=1e-3)
C, G, N, P = 6, 12, 10, 3
TINY = jnp.finfo(jnp.float32).tiny


def _np(a):
    return np.array(a, np.float32)


def _cfgs():
    kernel = dict(algorithm="newton", fused_accept=True)
    run = dict(chains=C, log_every_segment=False)
    return (
        SamplerConfig(kernel=KernelConfig(**kernel), run=RunConfig(**run)),
        tconfig.SamplerConfig(
            kernel=tconfig.KernelConfig(**kernel),
            run=tconfig.RunConfig(**run),
        ),
    )


@pytest.fixture(scope="module")
def setup():
    data, _ = synth_logistic(jax.random.key(11), G=G, n=N, p=P)
    jmodel = j_make(data, tau_prior="invgamma")
    jcfg, tcfg = _cfgs()
    jstate = j_init_state(jmodel, jcfg, jax.random.key(2), data)
    tdata = from_numpy(data.x, data.y, data.mask, device="cpu")
    tmodel = make_hier_logistic(tdata, tau_prior="invgamma")
    return data, jmodel, jcfg, jstate, tdata, tmodel, tcfg


def _replay_noise(state):
    """The noise one reference sweep draws, in the order the port asks."""
    _, key_sweep = jax.random.split(state.key)
    beta = state.position["beta"]
    kr = jax.random.fold_in(jax.random.fold_in(key_sweep, 0), 0)
    k_eps, k_u = jax.random.split(kr)
    out = [
        jax.random.normal(k_eps, beta.shape, jnp.float32),
        jnp.log(jax.random.uniform(k_u, (C, G), jnp.float32, minval=TINY)),
        jax.random.normal(jax.random.fold_in(key_sweep, 1), (C, P)),
        jax.random.gamma(jax.random.fold_in(key_sweep, 2), 2.0 + 0.5 * G,
                         shape=(C, P), dtype=jnp.float32),
    ]
    km = jax.random.fold_in(jax.random.fold_in(key_sweep, 1000), 0)
    k1, k2 = jax.random.split(km)
    out += [
        jax.random.normal(k1, (C, 2 * P), jnp.float32),
        jnp.log(jax.random.uniform(k2, (C,), jnp.float32, minval=TINY)),
    ]
    return [_np(a) for a in out]


def _port_state(jstate):
    return state_from_numpy(
        {k: _np(v) for k, v in jstate.position.items()},
        {k: _np(v) for k, v in jstate.log_scale.items()},
        {k: _np(v) for k, v in jstate.accept_sum.items()},
        {k: None if c is None else {kk: _np(vv) for kk, vv in c.items()}
         for k, c in jstate.cache.items()},
        t=int(jstate.t), device="cpu",
    )


def _compare_states(tstate, jstate):
    for k, v in jstate.position.items():
        np.testing.assert_allclose(tstate.position[k].numpy(), _np(v),
                                   **TOL, err_msg=k)
    for k, v in jstate.accept_sum.items():
        np.testing.assert_allclose(tstate.accept_sum[k].numpy(), _np(v),
                                   **TOL, err_msg=k)
    for kk in ("v", "g", "h"):
        np.testing.assert_allclose(
            tstate.cache["beta"][kk].numpy(),
            _np(jstate.cache["beta"][kk]), **TOL, err_msg=kk,
        )
    assert tstate.t == int(jstate.t)


def test_init_cache_matches(setup):
    data, jmodel, jcfg, jstate, tdata, tmodel, tcfg = setup
    pos = {k: torch.as_tensor(_np(v)) for k, v in jstate.position.items()}
    tstate = init_kernel_state(tmodel, tcfg, None, tdata, position=pos)
    for kk in ("v", "g", "h"):
        np.testing.assert_allclose(
            tstate.cache["beta"][kk].numpy(),
            _np(jstate.cache["beta"][kk]), rtol=1e-5, atol=1e-4,
        )
    for k, v in jstate.log_scale.items():
        np.testing.assert_allclose(tstate.log_scale[k].numpy(), _np(v),
                                   rtol=1e-6)
    assert set(tstate.accept_sum) == set(jstate.accept_sum)


def test_warmup_then_sampling_sweep_match(setup):
    data, jmodel, jcfg, jstate, tdata, tmodel, tcfg = setup
    jsweep = j_make_sweep(jmodel, jcfg)
    tsweep = make_sweep(tmodel, tcfg)
    assert rhat_fold_names(tmodel, tcfg) == ("beta",)

    # warmup sweep: refreshed metric
    rng = ReplayRNG(_replay_noise(jstate))
    tstate = tsweep(_port_state(jstate), tdata, True, rng)
    jstate1 = jsweep(jstate, data, adapt=True)
    assert rng.remaining == 0
    _compare_states(tstate, jstate1)

    # sampling sweep: frozen metric + the fold of the pre-update beta
    acc = j_fold_init(jstate1.position, ("beta",))["beta"]
    r = np.random.default_rng(3)
    mean = r.standard_normal(acc[1].shape).astype(np.float32)
    m2 = r.random(acc[2].shape).astype(np.float32)
    count = np.array([5.0, 0.0], np.float32)
    jfold = {"beta": (jnp.asarray(mean), jnp.asarray(m2),
                      j_fold_scalars(jnp.asarray(count), jnp.int32(5), 8))}
    tfold = {"beta": (torch.as_tensor(mean), torch.as_tensor(m2),
                      fold_rhat_scalars(count, 5, 8))}
    rng = ReplayRNG(_replay_noise(jstate1))
    tstate2, tfout = tsweep(_port_state(jstate1), tdata, False, rng, tfold)
    jstate2, jfout = jsweep(jstate1, data, adapt=False, rhat_fold=jfold)
    assert rng.remaining == 0
    _compare_states(tstate2, jstate2)
    for a, b in zip(tfout["beta"], jfout["beta"]):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)
    # frozen: the sampling sweep carries the warmup Hessian unchanged
    np.testing.assert_array_equal(
        tstate2.cache["beta"]["h"].numpy(),
        _port_state(jstate1).cache["beta"]["h"].numpy(),
    )


@pytest.mark.parametrize("adapt", [True, False])
def test_sweep_path_ignores_fused_accept(setup, adapt):
    """The device, not KernelConfig.fused_accept(_warmup), picks the Newton
    step: with the flags off the sweep draws exactly what it draws with
    them on."""
    data, jmodel, jcfg, jstate, tdata, tmodel, tcfg = setup
    off = tconfig.SamplerConfig(
        kernel=tconfig.KernelConfig(algorithm="newton", fused_accept=False,
                                    fused_accept_warmup=False),
        run=tcfg.run,
    )
    outs = []
    for cfg in (tcfg, off):
        state = _port_state(jstate)
        outs.append(make_sweep(tmodel, cfg)(state, tdata, adapt,
                                            SweepRNG(5, "cpu")))
    for k, v in outs[0].position.items():
        torch.testing.assert_close(outs[1].position[k], v, rtol=0, atol=0)
    for kk in ("v", "g", "h"):
        torch.testing.assert_close(outs[1].cache["beta"][kk],
                                   outs[0].cache["beta"][kk], rtol=0, atol=0)
