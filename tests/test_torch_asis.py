"""The interweaving move's plain versions (ops/cuda/asis.py), which the CPU
route runs: the statistics rows against a float64 einsum, the proposal
and the decision against torch.linalg in float64 at p = 1..4, the
wrappers' argument checks, and the whole move (models/hier_logistic.py,
Laplace frozen and refreshed, Langevin) against a float64 form of the
same move built through (C, G, p, p) products. The card's kernels against
these versions: tests/test_torch_asis_cuda.py.
"""

import math

import pytest
import torch

from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.models.hier_logistic import PopulationPrior
from nestmc_torch.ops.cuda.asis import (
    asis_accept,
    asis_propose,
    asis_stats,
    row_width,
)
from nestmc_torch.ops.smallchol import pack_dense, unpack_dense
from nestmc_torch.rng import ReplayRNG

PRIORS = {"invgamma": PopulationPrior(1.0 / 25.0, True, 2.0, 0.5, 2.0),
          "halfnormal": PopulationPrior(1.0 / 4.0, False, 2.0, 0.5, 1.5)}


def _inputs(C, G, p, seed=0, shared_h=False):
    """beta, mu, log_tau, g and a packed h that is positive definite per
    group ((1, G, T) when shared_h)."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen)
    beta = 0.6 * r(C, G, p)
    mu = 0.3 * r(C, p)
    lt = -0.4 + 0.2 * r(C, p)
    g = r(C, G, p)
    a = r(1 if shared_h else C, G, p, p)
    h = pack_dense(a @ a.transpose(-1, -2) / p + 0.5 * torch.eye(p), p)
    return beta, mu, lt, g, h


def _stats64(beta, mu, g, h, ratio=None, v=None):
    """The (C, K) rows in float64 by einsum."""
    C, _, p = beta.shape
    d = (beta - mu[:, None, :]).double()
    if ratio is not None:
        d = d * ratio[:, None, :].double()
    g, h = g.double(), h.double()
    H = unpack_dense(h, p).expand(C, -1, -1, -1)
    hdd = torch.einsum("cgkl,cgk,cgl->ckl", H, d, d)
    dv = (torch.zeros(C, 1, dtype=torch.float64) if v is None
          else (v[0].double() - v[1].double()).sum(-1, keepdim=True))
    return torch.cat([
        torch.einsum("cgk->ck", g), torch.einsum("cgk,cgk->ck", g, d),
        pack_dense(torch.einsum("cgkl->ckl", H), p),
        torch.einsum("cgkl,cgk->ckl", H, d).reshape(C, p * p),
        pack_dense(hdd, p), dv], dim=-1)


def _metric64(row, mu, lt, prior):
    """Dense (C, 2p, 2p) metric and (C, 2p) gradient in float64."""
    row, mu, lt = row.double(), mu.double(), lt.double()
    C, p = mu.shape
    T = p * (p + 1) // 2
    S_H = unpack_dense(row[:, 2 * p:2 * p + T], p)
    S_Hd = row[:, 2 * p + T:2 * p + T + p * p].reshape(C, p, p)
    S_Hdd = unpack_dense(row[:, 2 * p + T + p * p:-1], p)
    eye = torch.eye(p, dtype=torch.float64)
    M = torch.cat([
        torch.cat([S_H + prior.inv_s0_2 * eye, S_Hd.transpose(-1, -2)], -1),
        torch.cat([S_Hd, S_Hdd + torch.diag_embed(
            prior.tau_logprior_metric(lt))], -1)], -2)
    f = torch.cat([row[:, :p] - mu * prior.inv_s0_2,
                   row[:, p:2 * p] + prior.tau_logprior_grad(lt)], -1)
    return M, f


def _propose64(row, mu, lt, eps, scale, beta, prior):
    p = mu.shape[1]
    M, f = _metric64(row, mu, lt, prior)
    L = torch.linalg.cholesky(M)
    s = 1.0 if scale is None else scale.double()
    drift = 1.0 if scale is None else 0.5 * s * s
    x = torch.cholesky_solve(f[..., None], L)[..., 0]
    z = torch.linalg.solve_triangular(L.transpose(-1, -2),
                                      eps.double()[..., None], upper=True)
    th = torch.cat([mu, lt], -1).double()
    th_new = th + drift * x + s * z[..., 0]
    ratio = torch.exp(th_new[:, p:] - lt.double())
    qa = 0.5 * (eps.double() ** 2).sum(-1) - torch.log(
        torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    beta_new = th_new[:, None, :p] + (beta.double()
                                      - mu.double()[:, None]) * ratio[:, None]
    return th_new, torch.cat([ratio, qa[:, None]], -1), beta_new


def _accept64(row, th_new, mu, lt, aux, scale, prior):
    p = mu.shape[1]
    th_new = th_new.double()
    mn, ln = th_new[:, :p], th_new[:, p:]
    M, f = _metric64(row, mn, ln, prior)
    L = torch.linalg.cholesky(M)
    s = 1.0 if scale is None else scale.double()
    drift = 1.0 if scale is None else 0.5 * s * s
    mean = th_new + drift * torch.cholesky_solve(f[..., None], L)[..., 0]
    w = L.transpose(-1, -2) @ (torch.cat([mu, lt], -1).double()
                               - mean)[..., None]
    inv_2s2 = 0.5 if scale is None else 0.5 / (s * s)[:, 0]
    q_corr = (-inv_2s2 * (w[..., 0] ** 2).sum(-1)
              + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
              + aux[:, p].double())
    guard = torch.where(ln.abs() < 12.0, 0.0, -math.inf)
    prior_delta = (prior.tau_logprior(ln) + guard
                   - prior.tau_logprior(lt.double())).sum(-1) + (
        -0.5 * (mn * mn - mu.double() ** 2) * prior.inv_s0_2).sum(-1)
    return row[:, -1].double() + prior_delta + q_corr


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["current", "shared_h", "proposal"])
def test_stats_rows_match_a_float64_einsum(p, case):
    C, G = 5, 7
    beta, mu, lt, g, h = _inputs(C, G, p, seed=p, shared_h=case == "shared_h")
    aux = v = ratio = None
    if case == "proposal":
        ratio = torch.exp(0.1 * torch.randn(C, p))
        aux = torch.cat([ratio, torch.zeros(C, 1)], -1)
        v = (torch.randn(C, G), torch.randn(C, G))
    row = asis_stats(beta, mu, g, h, aux, v)
    assert row.shape == (C, row_width(p)) and row.dtype == torch.float32
    want = _stats64(beta, mu, g, h, ratio, v)
    torch.testing.assert_close(row.double(), want, rtol=1e-5, atol=1e-5)
    if v is None:
        assert bool((row[:, -1] == 0).all())


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["laplace", "langevin"])
@pytest.mark.parametrize("tau", ["invgamma", "halfnormal"])
def test_propose_and_accept_match_linalg(p, mode, tau):
    C, G = 6, 9
    prior = PRIORS[tau]
    beta, mu, lt, g, h = _inputs(C, G, p, seed=10 + p)
    scale = None if mode == "laplace" else torch.full((C, 1), 0.7)
    eps = torch.randn(C, 2 * p, generator=torch.Generator().manual_seed(p))
    row = asis_stats(beta, mu, g, h)
    th_new, aux, beta_new = asis_propose(row, mu, lt, eps, scale, beta, prior)
    w_th, w_aux, w_beta = _propose64(row, mu, lt, eps, scale, beta, prior)
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(th_new.double(), w_th, **tol)
    torch.testing.assert_close(aux.double(), w_aux, **tol)
    torch.testing.assert_close(beta_new.double(), w_beta, **tol)
    g_new = torch.randn(C, G, p, generator=torch.Generator().manual_seed(7))
    v = (torch.randn(C, G), torch.randn(C, G))
    row_new = asis_stats(beta, mu, g_new, h, aux, v)
    logu = torch.log(torch.rand(C, generator=torch.Generator().manual_seed(3)))
    log_alpha, accept, alpha = asis_accept(row_new, th_new, mu, lt, aux,
                                           scale, logu, prior)
    want = _accept64(row_new, th_new, mu, lt, aux, scale, prior)
    torch.testing.assert_close(log_alpha.double(), want, rtol=1e-4,
                               atol=2e-4)
    assert accept.dtype == torch.bool
    assert torch.equal(accept, logu < log_alpha)
    torch.testing.assert_close(alpha, torch.exp(log_alpha.clamp_max(0.0)))


@pytest.mark.parametrize("where", ["current", "proposal"])
def test_a_metric_that_is_not_positive_definite_rejects(where):
    """A row whose summed Hessian is negative: NaN through the factor, the
    move rejects and alpha is 0."""
    C, G, p = 4, 5, 3
    prior = PRIORS["invgamma"]
    beta, mu, lt, g, h = _inputs(C, G, p)
    eps = torch.randn(C, 2 * p)
    row = asis_stats(beta, mu, g, h if where == "proposal" else -h)
    th_new, aux, _ = asis_propose(row, mu, lt, eps, None, beta, prior)
    assert bool(torch.isnan(th_new).any(-1).all()) == (where == "current")
    v = (torch.randn(C, G), torch.randn(C, G))
    row_new = asis_stats(beta, mu, g, -h, aux, v)
    log_alpha, accept, alpha = asis_accept(row_new, th_new, mu, lt, aux,
                                           None, torch.full((C,), -50.0),
                                           prior)
    assert bool(torch.isnan(log_alpha).all())
    assert not bool(accept.any())
    assert torch.equal(alpha, torch.zeros(C))


def _wrapper_calls(C=3, G=4, p=2):
    beta, mu, lt, g, h = _inputs(C, G, p)
    prior = PRIORS["invgamma"]
    row = asis_stats(beta, mu, g, h)
    eps = torch.randn(C, 2 * p)
    th_new, aux, _ = asis_propose(row, mu, lt, eps, None, beta, prior)
    return {
        "stats": (asis_stats, dict(beta=beta, mu=mu, g=g, h=h), "g"),
        "propose": (asis_propose, dict(row=row, mu=mu, log_tau=lt, eps=eps,
                                       scale=None, beta=beta, prior=prior),
                    "eps"),
        "accept": (asis_accept, dict(row=row, th_new=th_new, mu=mu,
                                     log_tau=lt, aux=aux, scale=None,
                                     logu=torch.zeros(C), prior=prior),
                   "th_new"),
    }


@pytest.mark.parametrize("wrapper", ["stats", "propose", "accept"])
@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "layout"])
def test_wrappers_raise_on_a_wrong_operand(wrapper, fault):
    fn, kw, name = _wrapper_calls()[wrapper]
    t = kw[name]
    if fault == "dtype":
        kw[name], err = t.double(), TypeError
    elif fault == "shape":
        kw[name], err = t[..., :-1].contiguous(), ValueError
    elif fault == "layout":
        # the right shape, not contiguous: both routes refuse it
        kw[name] = t.transpose(0, 1).contiguous().transpose(0, 1)
        err = ValueError
    else:
        kw[name], err = t.to("meta"), ValueError
    with pytest.raises(err):
        fn(**kw)


def test_wrappers_raise_on_a_device_without_kernels():
    fn, kw, _ = _wrapper_calls()["stats"]
    kw = {k: v.to("meta") for k, v in kw.items()}
    with pytest.raises(RuntimeError, match="no kernel for device"):
        fn(**kw)


def _move64(model_p, prior, beta, mu, lt, v, g, h, bound, scale, eps, logu,
            lik, refresh):
    """The move as the reference writes it, in float64 through (C, G, p, p)
    products: returns (beta', mu', lt', log alpha)."""
    p = model_p
    h_src = bound if h is None else h
    d = beta.double() - mu.double()[:, None]

    def stats(g_, h_, d_):
        C = d_.shape[0]
        H = unpack_dense(h_.double(), p).expand(C, -1, -1, -1)
        return torch.cat([
            g_.double().sum(1), (g_.double() * d_).sum(1),
            pack_dense(H.sum(1), p),
            torch.einsum("cgkl,cgk->ckl", H, d_).reshape(C, p * p),
            pack_dense(torch.einsum("cgkl,cgk,cgl->ckl", H, d_, d_), p),
            torch.zeros(C, 1, dtype=torch.float64)], -1)
    th_new, aux, beta_new = _propose64(stats(g, h_src, d), mu, lt, eps,
                                       scale, beta, prior)
    if refresh:
        v_new, g_new, h_new = lik(beta_new.float(), True)
    else:
        v_new, g_new = lik(beta_new.float(), False)
        h_new = h_src
    row = stats(g_new, h_new, d * aux[:, None, :p])
    row[:, -1] = (v_new.double() - v.double()).sum(-1)
    la = _accept64(row, th_new, mu, lt, aux, scale, prior)
    return beta_new, th_new[:, :p], th_new[:, p:], la


@pytest.mark.parametrize("mode", ["newton_frozen", "newton_refresh", "mala"])
@pytest.mark.parametrize("p", [3, 4])
def test_the_move_matches_its_float64_form(mode, p):
    """One move of each gradient mode on the CPU route against _move64 on
    the same noise: the positions of the chains whose decision is clear
    (|log alpha - log u| > 1e-3), log alpha and alpha."""
    torch.manual_seed(0)
    data, _ = synth_logistic(5, G=11, n=12, p=p, device="cpu")
    model = make_hier_logistic(data, tau_prior="invgamma")
    prior = PRIORS["invgamma"]
    C = 16
    beta = 0.4 * torch.randn(C, 11, p)
    mu, lt = 0.3 * torch.randn(C, p), -0.5 + 0.1 * torch.randn(C, p)
    newton = mode != "mala"
    v, g, h = model.cond_cached_newton["beta"][0](beta, data)
    cache = {"beta": {"v": v, "g": g, "h": h} if newton else {"v": v, "g": g}}
    scale = None if newton else torch.full((C, 1), 0.5)
    eps = torch.randn(C, 2 * p)
    # half the chains accept whatever log alpha is, half reject: both
    # sides of the selects run
    logu = torch.cat([torch.full((C // 2,), -math.inf),
                      torch.full((C // 2,), math.inf)])
    rng = ReplayRNG([eps, logu])
    pos, cup, alpha = model.joint_moves["asis_tau"](
        rng, {"beta": beta, "mu": mu, "log_tau": lt}, cache,
        torch.ones(C, 1) if scale is None else scale, data,
        frozen=mode == "newton_frozen")
    assert rng.remaining == 0

    def lik(b, hess):
        out = model.cond_cached_newton["beta"][0](b, data)
        return out if hess else out[:2]
    bound = torch.stack([
        0.25 * (data.mask.double() * data.x[..., i].double()
                * data.x[..., j].double()).sum(-1)
        for i in range(p) for j in range(i + 1)], -1)[None]
    b_new, mu_new, lt_new, la = _move64(
        p, prior, beta, mu, lt, v, g, h if newton else None, bound, scale,
        eps, logu, lik, mode == "newton_refresh")
    clear = (la - logu.double()).abs() > 1e-3
    acc = logu.double() < la
    assert int(acc.sum()) == C // 2 and bool(clear.all())
    torch.testing.assert_close(
        alpha.double()[clear], torch.exp(la.clamp_max(0.0))[clear],
        rtol=2e-3, atol=2e-4)
    want_mu = torch.where(acc[:, None], mu_new, mu.double())
    want_lt = torch.where(acc[:, None], lt_new, lt.double())
    want_b = torch.where(acc[:, None, None], b_new, beta.double())
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pos["mu"].double()[clear], want_mu[clear],
                               **tol)
    torch.testing.assert_close(pos["log_tau"].double()[clear],
                               want_lt[clear], **tol)
    torch.testing.assert_close(pos["beta"].double()[clear], want_b[clear],
                               **tol)
    assert set(cup["beta"]) == ({"v", "g", "h"} if newton else {"v", "g"})
    if mode == "newton_frozen":
        assert cup["beta"]["h"] is h
