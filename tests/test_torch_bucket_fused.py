"""The port's bucketed fused steps (ops/bucket.py) vs nestmc.ops.bucket.

- The bucketed fused MALA (shared and per-group scales) and Newton
  (refresh, frozen) steps vs the reference's with external noise (its
  Pallas steps in interpret mode), at tests/test_bucket_fused.py's
  tolerances: MALA alpha rtol 5e-3 / atol 5e-4, beta 1e-4, v rtol 1e-4 /
  atol 2e-4, g rtol 1e-3 / atol 5e-4; Newton alpha rtol 2e-3 / atol 2e-4,
  beta, v, g, h atol 2e-4. Frozen Newton returns h itself.
- Without noise, one draw of eps and log u per bucket, in bucket order.
- The flat-data Hessian bound of the grad-mode interweave: one move vs
  the reference's under replayed noise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.kernels.state import init_kernel_state as j_init_state
from nestmc.models import make_hier_logistic as j_make
from nestmc.models import synth_logistic as j_synth
from nestmc.ops import bucket as jb
from nestmc_torch.data import from_numpy_ragged
from nestmc_torch.models import make_hier_logistic
from nestmc_torch.ops import bucket as tb
from nestmc_torch.rng import ReplayRNG
from tests.test_torch_calibration import one_thread  # noqa: F401


def _np(a):
    return np.array(a, np.float32)


def _fused_setup(algorithm, C=8, G=23, n=9, p=3, seed=11):
    jdata, _ = j_synth(jax.random.key(seed), G=G, n=n, p=p, ragged=True,
                       min_obs=1)
    jmodel = j_make(jdata, loglik_impl="bucket", tau_prior="invgamma")
    jlay = jb.BucketLayout.build(np.asarray(jdata.segment_ids), G,
                                 min_groups=4)
    assert jb.covers_all_groups(jlay) and len(jlay.buckets) > 1
    cfg = SamplerConfig(kernel=KernelConfig(algorithm=algorithm),
                        run=RunConfig(chains=C, log_every_segment=False))
    state = j_init_state(jmodel, cfg, jax.random.key(1), jdata)
    data = from_numpy_ragged(jdata.x, jdata.y, jdata.segment_ids, G,
                             device="cpu")
    layout = tb.BucketLayout.build(data.segment_ids, G, min_groups=4,
                                   x=data.x, y=data.y)
    return jdata, jlay, state, layout


def _noise(key, C, G, p):
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, (C, G, p), jnp.float32)
    logu = jnp.log(jax.random.uniform(
        k_u, (C, G), jnp.float32, minval=jnp.finfo(jnp.float32).tiny))
    return eps, logu


def _t(a):
    return torch.as_tensor(_np(a))


@pytest.mark.parametrize("per_unit", [False, True])
def test_bucketed_mala_step_matches_reference(per_unit):
    jdata, jlay, state, layout = _fused_setup("mala")
    beta = state.position["beta"]
    C, G, p = beta.shape
    key = jax.random.key(7)
    ls = (jnp.linspace(-1.3, -0.9, C * G).reshape(C, G) if per_unit
          else jnp.full((C, 1), -1.1))
    eps, logu = _noise(key, C, G, p)
    c = state.cache["beta"]
    mu, lt = state.position["mu"], state.position["log_tau"]
    ref = jb.bucketed_fused_mala_step(
        key, beta, c["v"], c["g"], ls, mu, lt, jdata.x, jdata.y, jlay,
        noise=(eps, logu))
    out = tb.bucketed_fused_mala_step(
        _t(beta), _t(c["v"]), _t(c["g"]), _t(ls), _t(mu), _t(lt), layout,
        noise=(_t(eps), _t(logu)))
    assert 0.02 < float(out[3].mean()) < 0.999
    np.testing.assert_allclose(out[3].numpy(), _np(ref[3]), rtol=5e-3,
                               atol=5e-4)
    np.testing.assert_allclose(out[0].numpy(), _np(ref[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), _np(ref[1]), rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(out[2].numpy(), _np(ref[2]), rtol=1e-3,
                               atol=5e-4)


@pytest.mark.parametrize("frozen", [False, True])
def test_bucketed_newton_step_matches_reference(frozen):
    jdata, jlay, state, layout = _fused_setup("newton")
    beta = state.position["beta"]
    C, G, p = beta.shape
    key = jax.random.key(42)
    ls = state.log_scale["beta"]
    eps, logu = _noise(key, C, G, p)
    c = state.cache["beta"]
    mu, lt = state.position["mu"], state.position["log_tau"]
    ref = jb.bucketed_fused_newton_step(
        key, beta, c["v"], c["g"], c["h"], ls, mu, lt, jdata.x, jdata.y,
        jlay, noise=(eps, logu), frozen=frozen)
    th = _t(c["h"])
    out = tb.bucketed_fused_newton_step(
        _t(beta), _t(c["v"]), _t(c["g"]), th, _t(ls), _t(mu), _t(lt),
        layout, noise=(_t(eps), _t(logu)), frozen=frozen)
    np.testing.assert_allclose(out[4].numpy(), _np(ref[4]), rtol=2e-3,
                               atol=2e-4)
    for i in range(3):
        np.testing.assert_allclose(out[i].numpy(), _np(ref[i]), atol=2e-4)
    if frozen:
        assert out[3] is th
    else:
        np.testing.assert_allclose(out[3].numpy(), _np(ref[3]), atol=2e-4)


def test_bucketed_steps_draw_noise_per_bucket():
    """Without noise each bucket draws its own eps (C, Gb, p) and log u
    (C, Gb) in bucket order (on the card: one Philox key a launch)."""
    _, _, state, layout = _fused_setup("mala")
    beta = _t(state.position["beta"])
    C, G, p = beta.shape
    draws = []
    for b in layout.buckets:
        gb = len(b.obs_index)
        draws += [np.zeros((C, gb, p), np.float32),
                  np.zeros((C, gb), np.float32)]
    rng = ReplayRNG(draws)
    c = state.cache["beta"]
    tb.bucketed_fused_mala_step(
        beta, _t(c["v"]), _t(c["g"]), torch.full((C, 1), -1.0),
        _t(state.position["mu"]), _t(state.position["log_tau"]), layout,
        rng=rng)
    assert rng.remaining == 0


def test_grad_interweave_uses_the_flat_data_bound():
    """One grad-mode (MALA cache) interweaving move on ragged data: its
    preconditioner is the Hessian bound 0.25 sum_i x x^T per group, built
    from flat data with np.add.at, so the move equals the reference's
    under replayed noise only if the bound does."""
    jdata, _ = j_synth(jax.random.key(5), G=30, n=10, p=3, ragged=True,
                       min_obs=1)
    jmodel = j_make(jdata, loglik_impl="jnp")
    Cm = 8
    position = jmodel.init_state(jax.random.key(4), jdata, Cm)
    v, g = jmodel.cond_cached_grad["beta"][0](position["beta"], jdata)
    scale = jnp.full((Cm, 1), 0.4, jnp.float32)
    key = jax.random.key(11)
    jup, jcache, jalpha = jmodel.joint_moves["asis_tau"](
        key, position, {"beta": {"v": v, "g": g}}, scale, jdata)
    k1, k2 = jax.random.split(key)
    logu = jnp.log(jax.random.uniform(
        k2, (Cm,), jnp.float32, minval=jnp.finfo(jnp.float32).tiny))
    rng = ReplayRNG([_np(jax.random.normal(k1, (Cm, 6))), _np(logu)])
    data = from_numpy_ragged(jdata.x, jdata.y, jdata.segment_ids, 30,
                             device="cpu")
    model = make_hier_logistic(data, loglik_impl="pallas-segment")
    tup, tc, talpha = model.joint_moves["asis_tau"](
        rng, {k: _t(x) for k, x in position.items()},
        {"beta": {"v": _t(v), "g": _t(g)}}, _t(scale), data)
    assert rng.remaining == 0
    assert 0.02 < float(talpha.mean()) < 0.999
    np.testing.assert_allclose(talpha.numpy(), _np(jalpha), rtol=2e-3,
                               atol=2e-4)
    for k in jup:
        np.testing.assert_allclose(tup[k].numpy(), _np(jup[k]), atol=2e-4)
    for k in ("v", "g"):
        np.testing.assert_allclose(tc["beta"][k].numpy(),
                                   _np(jcache["beta"][k]), atol=2e-4)
