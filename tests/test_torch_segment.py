"""The port's ragged (segment) obs passes vs the JAX package, on the same
numpy inputs.

The plain segment functions (and the segment kernel wrappers, which run
them for CPU tensors) against nestmc.ops.loglik's lean segment functions
and the Pallas tiled-CSR kernels in interpret mode, over
tests/test_pallas_segment.py's four cases (empty groups, G % TG != 0,
multi-chunk tiles, half the groups empty), at its tolerances: loglik
rtol/atol 2e-5, gradient and packed Hessian rtol 2e-4 / atol 2e-5. Then
RaggedData and SegmentLayout, and the model's wiring on both ragged
routes ('bucket' and 'pallas-segment') against the JAX model's
cond_cached, cond_cached_grad and cond_cached_newton closures.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.data import RaggedData as JRaggedData
from nestmc.models import make_hier_logistic as j_make
from nestmc.models import synth_logistic as j_synth
from nestmc.ops import loglik as jl
from nestmc.ops.pallas.loglik_segment import (
    TiledSegmentLayout,
    logistic_loglik_segment_pallas,
    logistic_logp_grad_segment_pallas,
)
from nestmc_torch.data import from_numpy_ragged
from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.ops import loglik as tl
from nestmc_torch.ops.cuda.loglik_segment import (
    logistic_logp_grad_segment,
    logistic_loglik_segment,
)
from nestmc_torch.ops.segment import SegmentLayout

LL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)

CASES = [
    # (C, G, p, max_n, min_n, empty_every, TG, TN): test_pallas_segment.py
    (8, 37, 3, 12, 0, 5, 8, 16),      # empty groups, G % TG != 0
    (16, 64, 4, 9, 1, None, 16, 32),  # exact tiling
    (8, 5, 2, 40, 10, None, 8, 16),   # multi-chunk tiles, G < 2*TG
    (8, 20, 3, 3, 0, 2, 4, 8),        # half the groups empty
]


def _np(a):
    return np.array(a, np.float32)


def _ragged(seed, C, G, p, max_n, min_n=0, empty_every=None):
    r = np.random.default_rng(seed)
    sizes = r.integers(min_n, max_n + 1, size=G)
    if empty_every:
        sizes[::empty_every] = 0
    N = int(sizes.sum())
    seg = np.repeat(np.arange(G), sizes)
    x = r.standard_normal((N, p)).astype(np.float32)
    y = (r.random(N) < 0.5).astype(np.float32)
    beta = (0.7 * r.standard_normal((C, G, p))).astype(np.float32)
    return beta, x, y, seg


@pytest.mark.parametrize("case", CASES)
def test_plain_segment_passes_match_reference(case):
    C, G, p, max_n, min_n, empty_every, _, _ = case
    beta, x, y, seg = _ragged(1, C, G, p, max_n, min_n, empty_every)
    jb, jx, jy, js = (jnp.asarray(beta), jnp.asarray(x), jnp.asarray(y),
                      jnp.asarray(seg.astype(np.int32)))
    tb, tx, ty = (torch.as_tensor(a) for a in (beta, x, y))
    ts = torch.as_tensor(seg)
    np.testing.assert_allclose(
        tl.logistic_loglik_segment(tb, tx, ty, ts, G).numpy(),
        _np(jl.logistic_loglik_segment(jb, jx, jy, js, G)), **LL_TOL)
    ll, g = tl.logistic_logp_grad_segment(tb, tx, ty, ts, G)
    jll, jg = jl.logistic_logp_grad_segment(jb, jx, jy, js, G)
    np.testing.assert_allclose(ll.numpy(), _np(jll), **LL_TOL)
    np.testing.assert_allclose(g.numpy(), _np(jg), **GRAD_TOL)
    out = tl.logistic_logp_grad_hess_segment(tb, tx, ty, ts, G)
    ref = jl.logistic_logp_grad_hess_segment(jb, jx, jy, js, G)
    np.testing.assert_allclose(out[0].numpy(), _np(ref[0]), **LL_TOL)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), _np(b), **GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_segment_wrappers_match_pallas_interpret(case):
    C, G, p, max_n, min_n, empty_every, TG, TN = case
    beta, x, y, seg = _ragged(2, C, G, p, max_n, min_n, empty_every)
    jlay = TiledSegmentLayout.build(seg.astype(np.int32), G, tile_groups=TG,
                                    chunk_obs=TN)
    jargs = (jnp.asarray(beta), jnp.asarray(x), jnp.asarray(y), jlay)
    layout = SegmentLayout.build(seg, G, device="cpu")
    targs = (torch.as_tensor(beta), torch.as_tensor(x), torch.as_tensor(y),
             layout)
    np.testing.assert_allclose(
        logistic_loglik_segment(*targs).numpy(),
        _np(logistic_loglik_segment_pallas(*jargs, interpret=True)),
        **LL_TOL)
    ll, g = logistic_logp_grad_segment(*targs)
    jll, jg = logistic_logp_grad_segment_pallas(*jargs, interpret=True)
    np.testing.assert_allclose(ll.numpy(), _np(jll), **LL_TOL)
    np.testing.assert_allclose(g.numpy(), _np(jg), **GRAD_TOL)
    if empty_every:
        assert float(ll[:, ::empty_every].abs().max()) == 0.0


def test_layout_rejects_unsorted_and_out_of_range():
    with pytest.raises(ValueError):
        SegmentLayout.build(np.array([1, 0, 2]), 3)
    with pytest.raises(ValueError):
        SegmentLayout.build(np.array([0, 1, 3]), 3, device="cpu")
    lay = SegmentLayout.build(torch.tensor([0, 0, 2, 2, 2]), 4)
    assert lay.offsets.dtype == torch.int32
    assert lay.offsets.tolist() == [0, 2, 2, 5, 5]
    assert (lay.num_obs, lay.device.type) == (5, "cpu")


def test_ragged_data_matches_reference():
    """from_numpy_ragged takes the JAX RaggedData's leaves; the port's
    synth_logistic(ragged=True) draws sizes on [min_obs, n]."""
    jdata, _ = j_synth(jax.random.key(4), G=30, n=12, p=3, ragged=True,
                       min_obs=0)
    data = from_numpy_ragged(jdata.x, jdata.y, jdata.segment_ids,
                             jdata.num_groups, device="cpu")
    assert (data.num_obs, data.num_covariates) == (jdata.num_obs, 3)
    np.testing.assert_array_equal(data.sizes().numpy(),
                                  np.asarray(jdata.sizes()))
    assert data.offsets.tolist() == np.concatenate(
        [[0], np.cumsum(np.asarray(jdata.sizes()))]).tolist()
    with pytest.raises(ValueError):
        from_numpy_ragged(jdata.x, jdata.y, np.asarray(jdata.segment_ids)[::-1],
                          30, device="cpu")
    with pytest.raises(ValueError):
        from_numpy_ragged(jdata.x, jdata.y, jdata.segment_ids, 3,
                          device="cpu")
    tdata, truth = synth_logistic(3, G=50, n=9, p=2, ragged=True, min_obs=2,
                                  device="cpu")
    sizes = tdata.sizes().numpy()
    assert sizes.min() >= 2 and sizes.max() <= 9
    assert tdata.num_obs == sizes.sum() and truth["beta"].shape == (50, 2)
    assert bool((tdata.x[:, 0] == 1.0).all())
    for fn in (from_numpy_ragged, synth_logistic):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _model_pair(impl, G=37, n=9, p=3):
    jdata, _ = j_synth(jax.random.key(7), G=G, n=n, p=p, ragged=True,
                       min_obs=0)
    data = from_numpy_ragged(jdata.x, jdata.y, jdata.segment_ids, G,
                             device="cpu")
    return (j_make(jdata, loglik_impl="jnp"), jdata,
            make_hier_logistic(data, loglik_impl=impl), data)


@pytest.mark.parametrize("impl", ["pallas-segment", "bucket", "auto"])
def test_model_wiring_on_ragged_data(impl):
    """The closures the unfused updates and the fused steps' caches read
    (cond_cached, cond_cached_grad, cond_cached_newton) equal the JAX
    model's on the jnp-segment route, as
    test_hier_logistic_ragged_model_wiring holds the reference's."""
    jmodel, jdata, model, data = _model_pair(impl)
    assert model.loglik_impls["selected"] == (
        "bucket" if impl == "auto" else impl)
    beta = _np(0.5 * jax.random.normal(jax.random.key(8), (4, 37, 3)))
    tb = torch.as_tensor(beta)
    np.testing.assert_allclose(
        model.cond_cached["beta"][0](tb, data).numpy(),
        _np(jmodel.cond_cached["beta"][0](jnp.asarray(beta), jdata)),
        **LL_TOL)
    v, g = model.cond_cached_grad["beta"][0](tb, data)
    jv, jg = jmodel.cond_cached_grad["beta"][0](jnp.asarray(beta), jdata)
    np.testing.assert_allclose(v.numpy(), _np(jv), **LL_TOL)
    np.testing.assert_allclose(g.numpy(), _np(jg), **GRAD_TOL)
    out = model.cond_cached_newton["beta"][0](tb, data)
    ref = jmodel.cond_cached_newton["beta"][0](jnp.asarray(beta), jdata)
    np.testing.assert_allclose(out[0].numpy(), _np(ref[0]), **LL_TOL)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), _np(b), **GRAD_TOL)
    # min_obs=0 leaves empty groups: no bucketed fused step, no RW one
    assert model.fused_updates == model.fused_updates_mala == {}
    assert model.fused_updates_newton == {}


def test_model_rejects_other_routes():
    _, _, _, data = _model_pair("bucket")
    with pytest.raises(ValueError):
        make_hier_logistic(data, loglik_impl="jnp")
    padded, _ = synth_logistic(0, G=3, n=4, p=2, device="cpu")
    with pytest.raises(ValueError):
        make_hier_logistic(padded, loglik_impl="pallas-segment")
    assert make_hier_logistic(padded).loglik_impls == {"selected": "pallas"}


def test_segment_route_runs_the_unfused_updates():
    """On 'pallas-segment' every update is unfused, and the Newton cache's
    Hessian is the plain segment pass (the reference has no kernel for
    it)."""
    jdata, _ = j_synth(jax.random.key(9), G=12, n=8, p=2, ragged=True)
    assert isinstance(jdata, JRaggedData)
    data = from_numpy_ragged(jdata.x, jdata.y, jdata.segment_ids, 12,
                             device="cpu")
    model = make_hier_logistic(data, loglik_impl="pallas-segment",
                               tau_prior="invgamma")
    assert not (model.fused_updates or model.fused_updates_mala
                or model.fused_updates_newton)
    beta = torch.randn(3, 12, 2)
    ll, g, h = model.cond_cached_newton["beta"][0](beta, data)
    ref = tl.logistic_logp_grad_hess_segment(beta, data.x, data.y,
                                             data.segment_ids, 12)
    for a, b in zip((ll, g, h), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
