"""WAIC and PSIS-LOO of the port (nestmc_torch/compare.py), and the
per-unit log-likelihoods they read, held against the JAX package.

- The port's copy of the estimators against nestmc.compare on the same
  arrays: waic, psis_loo (with and without ``chunk``), gpdfit and compare
  agree to 1e-10 (rtol and atol; both are float64 numpy).
- Twins of tests/test_compare.py's estimator tests (gpdfit recovers a
  simulated GPD; WAIC's zero penalty; PSIS-LOO against the exact LOO of a
  conjugate normal model; WAIC close to it; the smoothed tail capped at
  the largest raw weight; compare's ranking and paired se), with the
  reference's thresholds.
- ``group_loglik`` of the port's hier_logistic against the reference
  model's ``derived["group_loglik"]`` on the same beta and data: padded
  (the reference's own CPU path), ragged on the bucket route and on the
  segment route (with empty groups); nested_poisson's ``subject_loglik``
  and ``group_loglik``; rtol 1e-5, atol 1e-5 (float32 sums in another
  order). The twin of tests/test_compare.py:105,136: the hier_glm
  poisson family's group_loglik collected from a run (finite, WAIC
  finite), and against the reference model's at the same beta, with the
  binomial family's on the pmf scale.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nestmc.models import make_hier_logistic as j_make_logistic
from nestmc.models.hier_glm import make_hier_glm as j_make_glm
from nestmc.models import make_nested_poisson as j_make_poisson
from nestmc.models import synth_logistic as j_synth_logistic
from nestmc.models import synth_poisson3 as j_synth_poisson3
from nestmc_torch.compare import (
    _psis_smooth_tail,
    compare,
    gpdfit,
    psis_loo,
    waic,
)
from nestmc_torch.data import from_numpy, from_numpy3, from_numpy_ragged
from nestmc_torch.models import (
    make_hier_glm,
    make_hier_logistic,
    make_nested_poisson,
)
from tests.test_torch_calibration import one_thread  # noqa: F401

jcompare = importlib.import_module("nestmc.compare")
EXACT = dict(rtol=1e-10, atol=1e-10)


def _ll(seed, s=600, g=23):
    """Heavy-tailed per-unit log-likelihood draws with ties in a few
    columns (zero exceedances in the tail fit)."""
    r = np.random.default_rng(seed)
    ll = -np.abs(r.standard_t(df=3, size=(s, g))) - 1.0
    for j in range(0, g, 6):
        top = np.argsort(ll[:, j])[-4:]
        ll[top, j] = ll[top[0], j]
    return ll


def _assert_result_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   err_msg=k, **EXACT)


@pytest.mark.parametrize("seed,shape", [(1, (600, 23)), (2, (3, 200, 9)),
                                        (3, (8, 5))])
def test_waic_matches_reference(seed, shape):
    ll = _ll(seed, int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    _assert_result_equal(waic(ll), jcompare.waic(ll))


@pytest.mark.parametrize("chunk", [None, 4, 7])
def test_psis_loo_matches_reference(chunk):
    ll = _ll(4)
    got, want = psis_loo(ll, chunk=chunk), jcompare.psis_loo(ll, chunk=chunk)
    assert np.array_equal(np.isfinite(got["k_hat"]),
                          np.isfinite(want["k_hat"]))
    _assert_result_equal(got, want)


@pytest.mark.parametrize("n", [3, 40, 4000])
def test_gpdfit_matches_reference(n):
    r = np.random.default_rng(n)
    x = 2.0 * (np.power(r.uniform(size=n), -0.3) - 1.0) / 0.3
    np.testing.assert_allclose(gpdfit(x), jcompare.gpdfit(x), **EXACT)


def test_compare_matches_reference():
    res = {"a": waic(_ll(5)), "b": waic(_ll(6)), "c": psis_loo(_ll(7))}
    jres = {"a": jcompare.waic(_ll(5)), "b": jcompare.waic(_ll(6)),
            "c": jcompare.psis_loo(_ll(7))}
    got, want = compare(res), jcompare.compare(jres)
    assert [r["model"] for r in got] == [r["model"] for r in want]
    for g, w in zip(got, want):
        for k in ("elpd", "elpd_diff", "diff_se"):
            np.testing.assert_allclose(g[k], w[k], **EXACT)


# ---- twins of tests/test_compare.py:17-93 ----

def test_gpdfit_recovers_shape_and_scale():
    rng = np.random.default_rng(7)
    k_true, sigma_true = 0.3, 2.0
    u = rng.uniform(size=4000)
    x = sigma_true * (np.power(u, -k_true) - 1.0) / k_true
    k, sigma = gpdfit(x)
    assert abs(k - k_true) < 0.08
    assert abs(sigma - sigma_true) / sigma_true < 0.15


def test_gpdfit_negative_shape():
    rng = np.random.default_rng(8)
    k_true, sigma_true = -0.2, 1.0
    u = rng.uniform(size=4000)
    x = sigma_true * (np.power(u, -k_true) - 1.0) / k_true
    k, _ = gpdfit(x)
    assert abs(k - k_true) < 0.12


def test_waic_constant_loglik_has_zero_penalty():
    ll = np.tile(np.array([[-1.3, -0.4, -2.2]]), (50, 1))
    r = waic(ll)
    np.testing.assert_allclose(r["p_i"], 0.0, atol=1e-12)
    np.testing.assert_allclose(r["elpd_i"], ll[0], rtol=1e-12)
    assert r["waic"] == pytest.approx(-2.0 * ll[0].sum())


def _normal_conjugate_case(n=40, s=40_000, seed=3):
    """y_i ~ N(mu, 1), mu ~ N(0, 25): exact posterior draws and the exact
    leave-one-out predictive."""
    rng = np.random.default_rng(seed)
    tau0sq = 25.0
    y = rng.normal(1.0, 1.0, size=n)
    post_var = 1.0 / (n + 1.0 / tau0sq)
    post_mean = post_var * y.sum()
    mu = rng.normal(post_mean, np.sqrt(post_var), size=s)
    ll = -0.5 * np.log(2 * np.pi) - 0.5 * (y[None, :] - mu[:, None]) ** 2
    v_m = 1.0 / (n - 1 + 1.0 / tau0sq)
    m_m = v_m * (y.sum() - y)
    pred_var = 1.0 + v_m
    exact_i = (-0.5 * np.log(2 * np.pi * pred_var)
               - 0.5 * (y - m_m) ** 2 / pred_var)
    return ll, exact_i


def test_psis_loo_matches_exact_loo_conjugate_normal():
    ll, exact_i = _normal_conjugate_case()
    r = psis_loo(ll)
    assert np.all(r["k_hat"] < 0.7), r["k_hat"].max()
    np.testing.assert_allclose(r["elpd_i"], exact_i, atol=0.02)
    assert r["elpd_loo"] == pytest.approx(exact_i.sum(), abs=0.25)


def test_waic_close_to_loo_well_behaved():
    ll, exact_i = _normal_conjugate_case(seed=11)
    w = waic(ll)
    assert w["elpd_waic"] == pytest.approx(exact_i.sum(), abs=0.4)
    assert 0.0 < w["p_waic"] < 3.0


def test_psis_smoothing_caps_at_max_raw_weight():
    rng = np.random.default_rng(5)
    logw = rng.standard_t(df=2, size=2000)
    logw -= logw.max()
    sm, k = _psis_smooth_tail(logw)
    assert np.isfinite(k)
    assert sm.max() <= logw.max() + 1e-12
    assert np.sum(sm != logw) <= int(min(0.2 * 2000, 3 * np.sqrt(2000)))


def test_compare_ranks_and_pairwise_se():
    ll_good, _ = _normal_conjugate_case(seed=21)
    ll_bad = ll_good - np.abs(
        np.random.default_rng(4).normal(0.5, 0.1, size=ll_good.shape[1]))
    rows = compare({"good": waic(ll_good), "bad": waic(ll_bad)})
    assert rows[0]["model"] == "good"
    assert rows[0]["elpd_diff"] == 0.0
    assert rows[1]["elpd_diff"] > 0.0
    assert rows[1]["diff_se"] > 0.0


# ---- the per-unit logliks against the reference models ----

TOL = dict(rtol=1e-5, atol=1e-5)


def _beta(C, G, p, seed):
    return (0.6 * np.random.default_rng(seed).standard_normal((C, G, p))
            ).astype(np.float32)


@pytest.mark.parametrize("impl", ["padded", "bucket", "pallas-segment"])
def test_group_loglik_matches_reference(impl):
    """Padded data (the reference's own CPU path) and ragged data with
    empty groups on both of the port's routes (the reference's jnp segment
    pass), on the same beta; log_s2 too."""
    C, G, p = 9, 30, 3
    ragged = impl != "padded"
    jd, _ = j_synth_logistic(jax.random.key(12), G=G, n=15, p=p,
                             ragged=ragged, min_obs=0)
    if ragged:
        sizes = np.bincount(np.asarray(jd.segment_ids), minlength=G)
        assert (sizes == 0).any()
        td = from_numpy_ragged(jd.x, jd.y, jd.segment_ids, G, device="cpu")
        tm = make_hier_logistic(td, loglik_impl=impl)
        jm = j_make_logistic(jd, loglik_impl="jnp")
    else:
        td = from_numpy(jd.x, jd.y, jd.mask, device="cpu")
        tm, jm = make_hier_logistic(td), j_make_logistic(jd)
    beta = _beta(C, G, p, 3)
    mu = beta.mean(axis=1) + 0.1
    want = {k: np.asarray(jm.derived[k]({"beta": jnp.asarray(beta),
                                         "mu": jnp.asarray(mu)}))
            for k in ("group_loglik", "log_s2")}
    got = {k: tm.derived[k]({"beta": torch.from_numpy(beta),
                             "mu": torch.from_numpy(mu)}).numpy()
           for k in ("group_loglik", "log_s2")}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_poisson_unit_logliks_match_reference():
    C, G, K, p = 7, 6, 3, 2
    jd, _ = j_synth_poisson3(jax.random.key(6), G=G, subjects_per_group=K,
                             n=5, p=p)
    td = from_numpy3(jd.x, jd.y, jd.mask, jd.subject_group, G,
                     device="cpu")
    tm, jm = make_nested_poisson(td), j_make_poisson(jd)
    beta_s = _beta(C, G * K, p, 8) * 0.5
    for k in ("subject_loglik", "group_loglik"):
        want = np.asarray(jm.derived[k]({"beta_s": jnp.asarray(beta_s)}))
        got = tm.derived[k]({"beta_s": torch.from_numpy(beta_s)}).numpy()
        assert got.shape == want.shape == (C, G * K if k[0] == "s" else G)
        np.testing.assert_allclose(got, want, err_msg=k, **TOL)


def test_glm_group_loglik():
    """hier_glm's per-group loglik draws for compare(): collected from a
    poisson run, and the poisson and binomial families' against the
    reference's on the same state."""
    from nestmc_torch import RunConfig, SamplerConfig, sample
    from tests.test_torch_hier_glm import glm_data, glm_state

    for family in ("poisson", "binomial"):
        jd, td = glm_data(family, seed=5, G=12, n=8, p=2)
        st = glm_state(family, C=4, G=12, p=2)
        got = make_hier_glm(td, family=family).derived["group_loglik"](
            {k: torch.from_numpy(v) for k, v in st.items()}).numpy()
        want = np.asarray(j_make_glm(jd, family=family).derived[
            "group_loglik"]({k: jnp.asarray(v) for k, v in st.items()}))
        assert got.shape == want.shape == (4, 12)
        np.testing.assert_allclose(got, want, err_msg=family, **TOL)
        if family == "poisson":
            post = sample(make_hier_glm(td, family=family), td,
                          SamplerConfig(run=RunConfig(
                              chains=4, warmup=60, draws=80, seed=0,
                              collect={"group_loglik": None},
                              log_every_segment=False)))
            ll = post.draws["group_loglik"].numpy()
            assert ll.shape == (4, 80, 12) and np.all(np.isfinite(ll))
            assert np.isfinite(waic(ll)["elpd_waic"])
