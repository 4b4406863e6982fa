"""The port's bucketed ragged route (ops/bucket.py) vs nestmc.ops.bucket.

- BucketLayout: the same buckets as the reference's, group for group and
  observation for observation (group_index, obs_index, cap), over
  tests/test_bucket.py's cases, its min-groups merge and size-0 groups.
- The three bucketed obs passes vs the reference's (jnp per bucket) and
  the port's plain segment functions: loglik rtol/atol 2e-5, gradient and
  Hessian rtol 2e-4 / atol 2e-5 (tests/test_bucket.py).
- The size-0 guard withholding the fused tables, and data.bucket_by_size.

The fused steps are in tests/test_torch_bucket_fused.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.data import bucket_by_size as j_bucket_by_size
from nestmc.models import synth_logistic as j_synth
from nestmc.ops import bucket as jb
from nestmc_torch.data import bucket_by_size, from_numpy_ragged
from nestmc_torch.models import make_hier_logistic
from nestmc_torch.ops import bucket as tb
from nestmc_torch.ops import loglik as tl

LL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)

CASES = [
    # (C, G, p, max_n, min_n, empty_every): tests/test_bucket.py
    (8, 64, 3, 33, 0, 7),
    (4, 128, 2, 129, 1, None),
    (8, 16, 4, 5, 0, 2),
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


def _same_layout(layout, jlayout):
    assert len(layout.buckets) == len(jlayout.buckets)
    for b, jbk in zip(layout.buckets, jlayout.buckets):
        assert b.cap == jbk.cap
        np.testing.assert_array_equal(b.group_index.numpy(),
                                      np.asarray(jbk.group_index))
        np.testing.assert_array_equal(b.obs_index,
                                      np.asarray(jbk.obs_index))
    assert layout.padded_obs() == jlayout.padded_obs()
    assert tb.covers_all_groups(layout) == jb.covers_all_groups(jlayout)


@pytest.mark.parametrize("min_groups", [4, 32])
@pytest.mark.parametrize("case", CASES)
def test_layout_matches_reference(case, min_groups):
    C, G, p, max_n, min_n, empty_every = case
    _, x, y, seg = _ragged(11, C, G, p, max_n, min_n, empty_every)
    layout = tb.BucketLayout.build(seg, G, min_groups=min_groups,
                                   x=torch.as_tensor(x), y=torch.as_tensor(y))
    _same_layout(layout, jb.BucketLayout.build(seg.astype(np.int32), G,
                                               min_groups=min_groups))
    for b in layout.buckets:
        valid = b.obs_index >= 0
        np.testing.assert_array_equal(b.mask.numpy(), valid)
        np.testing.assert_array_equal(
            b.y.numpy(), np.where(valid, y[np.maximum(b.obs_index, 0)], 0))
        assert tuple(b.x.shape) == (len(b.obs_index), b.cap, p)


def test_layout_merge_rule_and_empty_groups():
    sizes = np.array([1] * 2 + [3] * 2 + [60] * 40 + [0] * 3)
    seg = np.repeat(np.arange(sizes.size), sizes)
    for mg in (1, 8, 64):
        layout = tb.BucketLayout.build(seg, sizes.size, min_groups=mg)
        _same_layout(layout, jb.BucketLayout.build(seg, sizes.size,
                                                   min_groups=mg))
        assert not tb.covers_all_groups(layout)
    explicit = tb.BucketLayout.build(seg, sizes.size, edges=[4, 64])
    _same_layout(explicit, jb.BucketLayout.build(seg, sizes.size,
                                                 edges=[4, 64]))
    with pytest.raises(ValueError):
        tb.BucketLayout.build(np.array([1, 0, 2]), 3)


@pytest.mark.parametrize("case", CASES)
def test_bucketed_obs_passes_match_reference(case):
    C, G, p, max_n, min_n, empty_every = case
    beta, x, y, seg = _ragged(12, C, G, p, max_n, min_n, empty_every)
    jlay = jb.BucketLayout.build(seg.astype(np.int32), G, min_groups=4)
    layout = tb.BucketLayout.build(seg, G, min_groups=4,
                                   x=torch.as_tensor(x), y=torch.as_tensor(y))
    jargs = (jnp.asarray(beta), jnp.asarray(x), jnp.asarray(y), jlay)
    t_beta = torch.as_tensor(beta)
    np.testing.assert_allclose(
        tb.bucketed_logistic_loglik(t_beta, layout).numpy(),
        _np(jb.bucketed_logistic_loglik(*jargs)), **LL_TOL)
    ll, g = tb.bucketed_logistic_logp_grad(t_beta, layout)
    jll, jg = jb.bucketed_logistic_logp_grad(*jargs)
    np.testing.assert_allclose(ll.numpy(), _np(jll), **LL_TOL)
    np.testing.assert_allclose(g.numpy(), _np(jg), **GRAD_TOL)
    out = tb.bucketed_logistic_logp_grad_hess(t_beta, layout)
    ref = jb.bucketed_logistic_logp_grad_hess(*jargs)
    np.testing.assert_allclose(out[0].numpy(), _np(ref[0]), **LL_TOL)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), _np(b), **GRAD_TOL)
    # and the port's own plain segment pass, empty groups at exactly 0
    seg_t = torch.as_tensor(seg)
    plain = tl.logistic_logp_grad_hess_segment(
        t_beta, torch.as_tensor(x), torch.as_tensor(y), seg_t, G)
    for a, b in zip(out, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    if empty_every:
        assert float(out[0][:, ::empty_every].abs().max()) == 0.0


def test_size0_group_withholds_the_fused_tables():
    jdata, _ = j_synth(jax.random.key(3), G=40, n=12, p=3, ragged=True)
    seg = np.asarray(jdata.segment_ids) + 1       # group 0 has no obs
    data = from_numpy_ragged(jdata.x, jdata.y, seg, 41, device="cpu")
    assert not tb.covers_all_groups(tb.BucketLayout.build(seg, 41))
    model = make_hier_logistic(data, loglik_impl="bucket")
    assert model.fused_updates_mala == model.fused_updates_newton == {}
    full = from_numpy_ragged(jdata.x, jdata.y, jdata.segment_ids, 40,
                             device="cpu")
    model = make_hier_logistic(full)
    assert set(model.fused_updates_mala) == {"beta"}
    assert set(model.fused_updates_newton) == {"beta"}
    assert model.fused_updates == {}              # RW stays padded-only


def test_bucket_by_size_matches_reference():
    r = np.random.default_rng(3)
    sizes = [5, 0, 1, 9, 16, 17, 3, 2]
    ys = [(r.random(n) < 0.5).astype(np.float32) for n in sizes]
    xs = [r.standard_normal((n, 2)).astype(np.float32) for n in sizes]
    for edges in (None, [4, 32]):
        got = bucket_by_size(ys, xs, bucket_edges=edges, device="cpu")
        ref = j_bucket_by_size(ys, xs, bucket_edges=edges)
        assert len(got) == len(ref)
        for (d, gi), (jd, jgi) in zip(got, ref):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
            for a, b in ((d.x, jd.x), (d.y, jd.y), (d.mask, jd.mask),
                         (d.sizes, jd.sizes)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
