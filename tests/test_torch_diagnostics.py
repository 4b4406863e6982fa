"""Every ported diagnostic vs nestmc.diagnostics on identical numpy draws,
including the streaming (standard and fold layout) accumulators and the
cross-chain ESS with its chi^2 lower bound. Tolerance rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc import diagnostics as jd
from nestmc_torch import diagnostics as td

RTOL = 1e-4


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(
        np.asarray(a, np.float32), np.asarray(b, np.float32),
        rtol=rtol, atol=atol,
    )


def _ar1(C=6, D=301, P=3, phi=0.6, seed=0):
    r = np.random.default_rng(seed)
    x = np.zeros((C, D, P))
    x[:, 0] = r.standard_normal((C, P))
    for t in range(1, D):
        x[:, t] = phi * x[:, t - 1] + r.standard_normal((C, P))
    x += np.arange(C)[:, None, None] * 0.05          # mild chain offsets
    return x.astype(np.float32)


def _ties(C=4, D=200, seed=1):
    r = np.random.default_rng(seed)
    return r.integers(0, 4, (C, D)).astype(np.float32)


@pytest.mark.parametrize("draws", [_ar1(), _ar1(D=200, P=1)[..., 0], _ties()],
                         ids=["ar1", "ar1_scalar", "ties"])
@pytest.mark.parametrize("name", ["split_rhat", "rhat", "ess", "ess_bulk",
                                  "ess_tail", "mcse_mean"])
def test_diagnostic_matches_reference(name, draws):
    out = getattr(td, name)(torch.as_tensor(draws))
    ref = getattr(jd, name)(jnp.asarray(draws))
    _close(out, ref, atol=1e-5)


def test_rank_normalize_and_offset_match():
    x = _ties()
    _close(td._rank_normalize(torch.as_tensor(x)),
           jd._rank_normalize(jnp.asarray(x)), atol=1e-5)
    n = 3072 * 4096
    ranks = np.array([1.0, n / 2, float(n)], np.float32)
    u = td._rank_to_u(torch.as_tensor(ranks), n)
    _close(u, jd._rank_to_u(jnp.asarray(ranks), n))
    assert float(u.max()) < 1.0 and float(u.min()) > 0.0


def test_diagnose_and_chunked_match_reference():
    draws = {"a": _ar1(), "b": _ar1(P=1, seed=4)[..., 0]}
    ref = jd.diagnose({k: jnp.asarray(v) for k, v in draws.items()})
    tdraws = {k: torch.as_tensor(v) for k, v in draws.items()}
    for out in (td.diagnose(tdraws),
                td.diagnose_chunked(tdraws, budget_bytes=1)):
        for k in draws:
            for stat in ref[k]:
                _close(out[k][stat], ref[k][stat], atol=1e-5)


def test_streaming_accumulators_match_reference():
    x = _ar1(C=5, D=41, P=2, seed=2)                  # odd D: leftover dropped
    D = x.shape[1]
    half = D // 2
    jacc = jd.streaming_rhat_init({"x": jnp.asarray(x[:, 0])})
    tacc = td.streaming_rhat_init({"x": torch.as_tensor(x[:, 0])})
    for j in range(D):
        jacc = jd.streaming_rhat_update(jacc, {"x": jnp.asarray(x[:, j])},
                                        j, half)
        tacc = td.streaming_rhat_update(tacc, {"x": torch.as_tensor(x[:, j])},
                                        j, half)
    for a, b in zip(tacc["x"], jacc["x"]):
        _close(a, b, atol=1e-5)
    _close(td.streaming_rhat_finalize(tacc)["x"],
           jd.streaming_rhat_finalize(jacc)["x"])
    _close(td.streaming_rhat_finalize(tacc)["x"],
           jd.split_rhat(jnp.asarray(x)))
    te, je = td.streaming_ess_finalize(tacc)["x"], jd.streaming_ess_finalize(
        jacc)["x"]
    for k in ("ess", "ess_lb"):
        _close(te[k], je[k])
    ref_e, ref_lb = jd.cross_chain_ess(jnp.asarray(x))
    out_e, out_lb = td.cross_chain_ess(torch.as_tensor(x))
    _close(out_e, ref_e)
    _close(out_lb, ref_lb)
    _close(te["ess"], ref_e)


def test_fold_accumulators_match_reference():
    """Kernel-layout fold, lagged one draw with a final flush as the
    engines run it, vs nestmc's fold and vs the standard layout."""
    x = _ar1(C=4, D=30, P=3, seed=5)
    C, D, P = x.shape
    half = D // 2
    jacc = jd.fold_rhat_init({"x": jnp.asarray(x[:, 0])}, ("x",))["x"]
    tacc = td.fold_rhat_init({"x": torch.as_tensor(x[:, 0])}, ("x",))["x"]
    assert tuple(tacc[1].shape) == (2, P, C)
    for j in range(D + 1):
        jm1 = j - 1
        jsc = jd.fold_rhat_scalars(jacc[0], jnp.int32(jm1), half)
        tsc = td.fold_rhat_scalars(tacc[0], jm1, half)
        _close(tsc, jsc)
        if jm1 < 0:
            continue
        xt = x[:, jm1].T
        jm, jm2 = jd.fold_rhat_update(jacc[1], jacc[2], jnp.asarray(xt), jsc)
        tm, tm2 = td.fold_rhat_update(tacc[1], tacc[2],
                                      torch.as_tensor(xt), tsc)
        jacc = (jacc[0] + jsc[:, 1], jm, jm2)
        tacc = (tacc[0] + tsc[:, 1], tm, tm2)
    for a, b in zip(tacc, jacc):
        _close(a, b, atol=1e-5)
    acc = {"x": tacc}
    _close(td.fold_rhat_finalize(acc)["x"],
           jd.fold_rhat_finalize({"x": jacc})["x"])
    _close(td.fold_rhat_finalize(acc)["x"], jd.split_rhat(jnp.asarray(x)))
    te = td.fold_ess_finalize(acc)["x"]
    je = jd.fold_ess_finalize({"x": jacc})["x"]
    for k in ("ess", "ess_lb"):
        _close(te[k], je[k])


def test_chi2_lower_quantile_matches_reference():
    for k in (3, 63, 2047):
        _close(td._chi2_lower_quantile(k, 0.05),
               jd._chi2_lower_quantile(jnp.asarray(k, jnp.float32), 0.05))
