"""The data layer's converters (nestmc_torch/data.py) and the plain passes
tests/test_data.py needs (nestmc_torch/ops/loglik.py).

Twins of the 7 tests of tests/test_data.py: the from_ragged / to_ragged
round trip, padded against segment logliks (logistic and Poisson, at the
reference's tolerances), pad_groups_to, the three-level wiring,
bucket_by_size, and (for the pytree registration) the containers as a
model's data: under torch.func.vmap and through a sampler sweep. Then
exact equality of every converter's arrays with the reference's on the
same lists: NestedData.from_ragged (with and without covariates, a group
cut to max_obs, an empty group, extra arrays), to_ragged, pad_groups_to,
RaggedData.from_ragged, NestedData3.from_ragged (equal and unequal
subjects per group) and subjects_per_group. normal_loglik_padded and
poisson_loglik_segment against the reference's (rtol = atol = 1e-5), and
the segmented sum against a scatter-add.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc.data import NestedData as JNestedData
from nestmc.data import NestedData3 as JNestedData3
from nestmc.data import RaggedData as JRaggedData
from nestmc.ops import normal_loglik_padded as j_normal_loglik_padded
from nestmc.ops import poisson_loglik_segment as j_poisson_loglik_segment
from nestmc_torch.config import RunConfig, SamplerConfig
from nestmc_torch.data import (
    NestedData,
    NestedData3,
    RaggedData,
    bucket_by_size,
    data_device,
    segment_offsets,
)
from nestmc_torch.kernels.gibbs import make_sweep
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.models import make_hier_logistic
from nestmc_torch.ops import loglik
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401

RNG = np.random.default_rng(1)
CPU = dict(device="cpu")


def ragged_lists(G=13, max_n=17, p=3, rng=RNG):
    sizes = rng.integers(1, max_n + 1, size=G)
    ys = [rng.integers(0, 2, size=s).astype(np.float32) for s in sizes]
    xs = [rng.normal(size=(s, p)).astype(np.float32) for s in sizes]
    return ys, xs


def test_from_ragged_roundtrip():
    ys, xs = ragged_lists()
    nd = NestedData.from_ragged(ys, xs, **CPU)
    assert nd.num_groups == len(ys)
    assert nd.max_obs == max(len(y) for y in ys)
    np.testing.assert_array_equal(nd.sizes.numpy(), [len(y) for y in ys])
    rd = nd.to_ragged()
    rd2 = RaggedData.from_ragged(ys, xs, **CPU)
    np.testing.assert_allclose(rd.y.numpy(), rd2.y.numpy())
    np.testing.assert_allclose(rd.x.numpy(), rd2.x.numpy())
    np.testing.assert_array_equal(rd.segment_ids.numpy(),
                                  rd2.segment_ids.numpy())
    np.testing.assert_array_equal(rd.sizes().numpy(), nd.sizes.numpy())


def test_padded_equals_segment_loglik():
    ys, xs = ragged_lists()
    nd = NestedData.from_ragged(ys, xs, **CPU)
    rd = RaggedData.from_ragged(ys, xs, **CPU)
    beta = torch.from_numpy(RNG.normal(
        size=(5, nd.num_groups, nd.num_covariates)).astype(np.float32))
    padded = loglik.logistic_loglik_padded(beta, nd.x, nd.y, nd.mask)
    segment = loglik.logistic_loglik_segment(beta, rd.x, rd.y,
                                             rd.segment_ids, rd.num_groups)
    np.testing.assert_allclose(padded.numpy(), segment.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_padded_equals_segment_poisson():
    ys, xs = ragged_lists()
    ys = [np.float32(RNG.poisson(2.0, size=len(y))) for y in ys]
    nd = NestedData.from_ragged(ys, xs, **CPU)
    rd = RaggedData.from_ragged(ys, xs, **CPU)
    beta = torch.from_numpy(RNG.normal(
        size=(4, nd.num_groups, nd.num_covariates)).astype(np.float32) * 0.3)
    padded = loglik.poisson_loglik_padded(beta, nd.x, nd.y, nd.mask)
    segment = loglik.poisson_loglik_segment(beta, rd.x, rd.y,
                                            rd.segment_ids, rd.num_groups)
    np.testing.assert_allclose(padded.numpy(), segment.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_pad_groups_to():
    ys, xs = ragged_lists(G=10)
    nd = NestedData.from_ragged(ys, xs, **CPU)
    nd2 = nd.pad_groups_to(16)
    assert nd2.num_groups == 16
    assert float(nd2.mask[10:].sum()) == 0.0
    beta = torch.zeros(3, 16, nd.num_covariates)
    ll = loglik.logistic_loglik_padded(beta, nd2.x, nd2.y, nd2.mask)
    assert np.all(ll[:, 10:].numpy() == 0.0)
    assert nd.pad_groups_to(10) is nd
    with pytest.raises(ValueError, match="G_pad"):
        nd.pad_groups_to(9)


def test_nested3_wiring():
    G, spg, n, p = 4, 3, 5, 2
    ys = [[RNG.poisson(2.0, size=n).astype(np.float32) for _ in range(spg)]
          for _ in range(G)]
    xs = [[RNG.normal(size=(n, p)).astype(np.float32) for _ in range(spg)]
          for _ in range(G)]
    d3 = NestedData3.from_ragged(ys, xs, **CPU)
    assert d3.num_subjects == G * spg
    assert d3.num_groups == G
    assert d3.max_obs == n
    np.testing.assert_array_equal(d3.subjects_per_group().numpy(),
                                  [spg] * G)
    np.testing.assert_array_equal(d3.subject_group.numpy(),
                                  np.repeat(np.arange(G), spg))


def test_bucket_by_size():
    ys, xs = ragged_lists(G=30, max_n=64)
    buckets = bucket_by_size(ys, xs, **CPU)
    seen = np.concatenate([idx.numpy() for _, idx in buckets])
    assert sorted(seen.tolist()) == list(range(30))
    for nd, idx in buckets:
        for row, orig in enumerate(idx.numpy()):
            assert int(nd.sizes[row]) == len(ys[orig])
            assert nd.max_obs >= int(nd.sizes[row])


def test_containers_are_model_data():
    """The pytree-registration twin: the containers pass, unchanged,
    through a vmapped function that captures them and through a sampler
    sweep, and the sampler finds their device."""
    ys, xs = ragged_lists(G=6)
    nd = NestedData.from_ragged(ys, xs, **CPU)
    rd = RaggedData.from_ragged(ys, xs, **CPU)
    for d in (nd, rd, nd.to_ragged()):
        assert data_device(d) == torch.device("cpu")
    beta = torch.zeros(4, 6, 3)
    out = torch.func.vmap(lambda b: torch.sum(loglik.logistic_loglik_padded(
        b[None], nd.x, nd.y, nd.mask)))(beta)
    assert out.shape == (4,) and bool(torch.isfinite(out).all())
    for d in (nd, rd):
        model = make_hier_logistic(d, tau_prior="invgamma")
        cfg = SamplerConfig(run=RunConfig(chains=4, log_every_segment=False))
        state = init_kernel_state(model, cfg, SweepRNG(0, "cpu"), d)
        state = make_sweep(model, cfg)(state, d, True, SweepRNG(1, "cpu"))
        assert all(bool(torch.isfinite(v).all())
                   for v in state.position.values())


# ---- exact equality with the reference's converters ----

def _lists(case):
    r = np.random.default_rng(11)
    ys, xs = ragged_lists(G=9, max_n=12, p=3, rng=r)
    # values that float32 does not hold exactly: the float64 staging and
    # the one cast must round them as the reference does
    ys = [y + r.normal(size=len(y)) / 3.0 for y in ys]
    xs = [x.astype(np.float64) / 7.0 for x in xs]
    kw = {}
    if case == "empty_group":
        ys[4], xs[4] = ys[4][:0], xs[4][:0]
    if case == "max_obs_cut":
        kw["max_obs"] = 6
    if case == "max_obs_pad":
        kw["max_obs"] = 20
    if case == "extra":
        kw["extra"] = {"scale": r.uniform(0.5, 2.0, size=9),
                       "w": r.normal(size=(9, 12))}
    return ys, (None if case == "no_xs" else xs), kw


CASES = ["xs", "no_xs", "max_obs_cut", "max_obs_pad", "empty_group",
         "extra"]


def _eq(ours, ref):
    ref = np.asarray(ref)
    ours = ours.cpu().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref.astype(ours.dtype))


def _eq_x(ours, ref_x, lead):
    if ref_x is None:
        assert tuple(ours.shape) == tuple(lead) + (0,)
    else:
        _eq(ours, ref_x)


@pytest.mark.parametrize("case", CASES)
def test_nested_from_ragged_equals_reference(case):
    ys, xs, kw = _lists(case)
    ours = NestedData.from_ragged(ys, xs, **kw, **CPU)
    ref = JNestedData.from_ragged(ys, xs, **kw)
    for f in ("y", "mask", "sizes"):
        _eq(getattr(ours, f), getattr(ref, f))
    assert ours.y.dtype == torch.float32 and ours.sizes.dtype == torch.int32
    _eq_x(ours.x, ref.x, ref.y.shape)
    assert ours.max_obs == ref.max_obs
    assert set(ours.extra) == set(ref.extra)
    for k in ref.extra:
        _eq(ours.extra[k], np.asarray(ref.extra[k], np.float32))


@pytest.mark.parametrize("case", CASES)
def test_to_ragged_equals_reference(case):
    ys, xs, kw = _lists(case)
    ours = NestedData.from_ragged(ys, xs, **kw, **CPU).to_ragged()
    ref = JNestedData.from_ragged(ys, xs, **kw).to_ragged()
    _eq(ours.y, ref.y)
    _eq(ours.segment_ids, ref.segment_ids)
    assert ours.segment_ids.dtype == torch.int64
    _eq_x(ours.x, ref.x, ref.y.shape)
    assert ours.num_groups == ref.num_groups
    _eq(ours.offsets, segment_offsets(np.asarray(ref.segment_ids),
                                      ref.num_groups))
    _eq(ours.sizes(), ref.sizes())
    assert set(ours.extra) == set(ref.extra)


@pytest.mark.parametrize("case", CASES)
def test_pad_groups_to_equals_reference(case):
    ys, xs, kw = _lists(case)
    ours = NestedData.from_ragged(ys, xs, **kw, **CPU).pad_groups_to(16)
    ref = JNestedData.from_ragged(ys, xs, **kw).pad_groups_to(16)
    for f in ("y", "mask", "sizes"):
        _eq(getattr(ours, f), getattr(ref, f))
    _eq_x(ours.x, ref.x, ref.y.shape)
    assert int(ours.sizes[9:].abs().sum()) == 0
    for k in ref.extra:
        _eq(ours.extra[k], np.asarray(ref.extra[k], np.float32))


@pytest.mark.parametrize("case", ["xs", "no_xs", "extra", "empty"])
def test_ragged_from_ragged_equals_reference(case):
    ys, xs, kw = _lists("extra" if case == "extra" else "xs")
    if case == "no_xs":
        xs = None
    if case == "empty":
        ys, xs = [], None
    kw.pop("max_obs", None)
    ours = RaggedData.from_ragged(ys, xs, **kw, **CPU)
    ref = JRaggedData.from_ragged(ys, xs, **kw)
    _eq(ours.y, ref.y)
    _eq(ours.segment_ids, ref.segment_ids)
    _eq_x(ours.x, ref.x, ref.y.shape)
    assert ours.num_groups == ref.num_groups
    _eq(ours.sizes(), ref.sizes())
    assert set(ours.extra) == set(ref.extra)
    for k in ref.extra:
        _eq(ours.extra[k], np.asarray(ref.extra[k], np.float32))


@pytest.mark.parametrize("case", ["equal", "unequal", "no_xs"])
def test_nested3_from_ragged_equals_reference(case):
    r = np.random.default_rng(4)
    counts = [3, 3, 3, 3] if case == "equal" else [2, 0, 4, 1]
    ys = [[r.poisson(2.0, size=int(r.integers(1, 6))) / 1.0
           for _ in range(c)] for c in counts]
    xs = None if case == "no_xs" else [
        [r.normal(size=(len(y), 2)) for y in grp] for grp in ys]
    extra = {"w": r.normal(size=4)}
    ours = NestedData3.from_ragged(ys, xs, extra=extra, **CPU)
    ref = JNestedData3.from_ragged(ys, xs, extra=extra)
    for f in ("y", "mask", "subject_group"):
        _eq(getattr(ours, f), getattr(ref, f))
    _eq_x(ours.x, ref.x, ref.y.shape)
    assert ours.num_groups == ref.num_groups
    assert ours.max_obs == ref.max_obs
    _eq(ours.subjects_per_group(), ref.subjects_per_group())
    assert ours.subjects_per_group().dtype == torch.int32
    _eq(ours.extra["w"], np.asarray(extra["w"], np.float32))
    assert (ours.members is None) == (len(set(counts)) == 1)


# ---- the plain passes tests/test_data.py needs ----

@pytest.mark.parametrize("sigma", ["scalar", "(C,1)", "(C,G)"])
def test_normal_loglik_padded_matches_reference(sigma):
    r = np.random.default_rng(8)
    C, G, n, p = 3, 5, 6, 2
    beta = r.normal(size=(C, G, p)).astype(np.float32)
    x = r.normal(size=(G, n, p)).astype(np.float32)
    y = r.normal(size=(G, n)).astype(np.float32)
    mask = (r.random((G, n)) < 0.8).astype(np.float32)
    s = {"scalar": 0.7, "(C,1)": r.uniform(0.5, 2, (C, 1)),
         "(C,G)": r.uniform(0.5, 2, (C, G))}[sigma]
    s = s if np.isscalar(s) else s.astype(np.float32)
    ours = loglik.normal_loglik_padded(
        *map(torch.from_numpy, (beta, x, y, mask)),
        s if np.isscalar(s) else torch.from_numpy(s))
    ref = j_normal_loglik_padded(*map(jnp.asarray, (beta, x, y, mask)),
                                 s if np.isscalar(s) else jnp.asarray(s))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("table", [False, True])
def test_poisson_loglik_segment_matches_reference(table):
    ys, xs = ragged_lists(G=7)
    ys = [np.float32(RNG.poisson(2.0, size=len(y))) for y in ys]
    rd = RaggedData.from_ragged(ys, xs, **CPU)
    jrd = JRaggedData.from_ragged(ys, xs)
    beta = (0.3 * RNG.normal(size=(4, 7, 3))).astype(np.float32)
    lg = torch.lgamma(rd.y + 1.0) if table else None
    ours = loglik.poisson_loglik_segment(torch.from_numpy(beta), rd.x, rd.y,
                                         rd.segment_ids, 7, lgamma_y=lg)
    ref = j_poisson_loglik_segment(
        jnp.asarray(beta), jrd.x, jrd.y, jrd.segment_ids, 7,
        lgamma_y=None if lg is None else jnp.asarray(lg.numpy()))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_segsum_is_a_segmented_sum():
    """The segment passes' reduction (no atomics) equals a scatter-add on
    the CPU bit for bit, with empty groups at either end and inside."""
    g = torch.Generator().manual_seed(2)
    seg = torch.sort(torch.randint(1, 40, (500,), generator=g)).values
    seg = seg[seg != 17]
    vals = torch.randn(6, seg.shape[0], generator=g)
    ours = loglik._segsum(vals, seg, 45)
    ref = torch.zeros(6, 45).index_add_(1, seg, vals)
    assert torch.equal(ours, ref)
    assert float(ours[:, [0, 17, 44]].abs().sum()) == 0.0
