"""The interweave's kernels (csrc/asis_move.cu) against their plain
versions, on the card.

Marked ``cuda``; each test skips itself when torch finds no CUDA device.
Run on a GPU host: ``python -m pytest --noconftest -m cuda
tests/test_torch_asis_cuda.py``. The whole move (models/hier_logistic.py)
on CUDA tensors, where it launches the kernels, against the same move on
CPU copies, where it runs the plain versions, on the same replayed noise,
in the Laplace mode (frozen and refreshing) and the Langevin mode at p = 3
and 4, with G = 300 groups (not a multiple of a block's threads); each
wrapper against its plain version on the same CUDA inputs; a chain slice
bitwise the full launch's rows, a group slice's proposal bitwise the full
launch's, the sums of two group slices against the full sums; a planted
metric that is not positive definite; the same bits twice; four kernel
launches a move. Tolerances: those of tests/test_torch_sweep_mala.py
(positions rtol 1e-4, atol 1e-3; alpha rtol 2e-3, atol 2e-4), float32
sums over groups in another order; decisions may differ only where
|log alpha - log u| < 1e-3.
"""

import pytest
import torch

from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.models.hier_logistic import PopulationPrior
from nestmc_torch.ops.cuda import LAUNCHES, _build, reset_launch_counts
from nestmc_torch.ops.cuda import asis
from nestmc_torch.ops.cuda.loglik_logistic import (
    logistic_logp_grad,
    logistic_logp_grad_hess,
)
from nestmc_torch.rng import ReplayRNG

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-3)
ALPHA_TOL = dict(rtol=2e-3, atol=2e-4)
DECIDE_TOL = 1e-3
PRIOR = PopulationPrior(1.0 / 25.0, True, 2.0, 0.5, 2.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(dev, C, G, p, seed, tau_prior="invgamma"):
    """A model on the card, its data, and a state near its posterior
    (beta = mu + tau z) with the Newton cache, all on ``dev``."""
    data, _ = synth_logistic(seed, G=G, n=16, p=p, device=dev)
    model = make_hier_logistic(data, tau_prior=tau_prior)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mu = 0.3 * torch.randn(C, p, generator=gen, device=dev)
    lt = -0.8 + 0.1 * torch.randn(C, p, generator=gen, device=dev)
    beta = mu[:, None] + torch.exp(lt)[:, None] * torch.randn(
        C, G, p, generator=gen, device=dev)
    v, g, h = logistic_logp_grad_hess(beta, data.x, data.y, data.mask)
    return model, data, {"beta": beta, "mu": mu, "log_tau": lt}, (v, g, h)


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x.cpu()


@pytest.mark.parametrize("mode", ["newton_frozen", "newton_refresh", "mala"])
@pytest.mark.parametrize("p", [3, 4])
def test_the_move_on_the_card_matches_the_plain_route(dev, mode, p):
    C, G = 130, 300
    model, data, pos, (v, g, h) = _state(dev, C, G, p, seed=p)
    newton = mode != "mala"
    cache = {"beta": {"v": v, "g": g, "h": h} if newton
             else {"v": v, "g": g}}
    scale = torch.full((C, 1), 0.6, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    eps = torch.randn(C, 2 * p, generator=gen, device=dev)
    logu = torch.log(torch.rand(C, generator=gen, device=dev))
    logu[-10:] = float("inf")         # these chains reject: both selects run
    frozen = mode == "newton_frozen"
    move = model.joint_moves["asis_tau"]
    reset_launch_counts()
    k_pos, k_cache, k_alpha = move(ReplayRNG([eps, logu], dev), pos, cache,
                                   scale, data, frozen=frozen)
    torch.cuda.synchronize()
    assert LAUNCHES["asis_stats"] == 2
    assert LAUNCHES["asis_propose"] == LAUNCHES["asis_accept"] == 1
    cpu_data, _ = synth_logistic(p, G=G, n=16, p=p, device="cpu")
    cpu_model = make_hier_logistic(cpu_data, tau_prior="invgamma")
    p_pos, p_cache, p_alpha = cpu_model.joint_moves["asis_tau"](
        ReplayRNG([eps.cpu(), logu.cpu()]), _cpu(pos), _cpu(cache),
        scale.cpu(), cpu_data, frozen=frozen)
    # the decisions: equal wherever log u is clear of log alpha
    la = torch.log(p_alpha.double().clamp_min(1e-300))
    clear = (la - logu.cpu().double()).abs() > DECIDE_TOL
    acc_k = ~torch.isclose(k_pos["log_tau"].cpu(), pos["log_tau"].cpu(),
                           rtol=0, atol=0).all(-1)
    acc_p = ~torch.isclose(p_pos["log_tau"], pos["log_tau"].cpu(),
                           rtol=0, atol=0).all(-1)
    assert torch.equal(acc_k[clear], acc_p[clear])
    assert int(acc_p.sum()) > 0 and not bool(acc_k[-10:].any())
    torch.testing.assert_close(k_alpha.cpu(), p_alpha, **ALPHA_TOL)
    for k in ("beta", "mu", "log_tau"):
        torch.testing.assert_close(k_pos[k].cpu()[clear], p_pos[k][clear],
                                   **TOL)
    for k in k_cache["beta"]:
        torch.testing.assert_close(k_cache["beta"][k].cpu()[clear],
                                   p_cache["beta"][k][clear], **TOL)
    if frozen:
        assert k_cache["beta"]["h"] is h


def _inputs(dev, C, G, p, laplace, seed=3):
    """Realistic operands of the three wrappers at one move."""
    model, data, pos, (v, g, h) = _state(dev, C, G, p, seed)
    beta, mu, lt = pos["beta"], pos["mu"], pos["log_tau"]
    x, y, m = data.x, data.y, data.mask
    if laplace:
        scale = None
    else:
        h = torch.stack([0.25 * (m * x[..., i] * x[..., j]).sum(-1)
                         for i in range(p) for j in range(i + 1)], -1)[None]
        scale = torch.full((C, 1), 0.4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    eps = torch.randn(C, 2 * p, generator=gen, device=dev)
    logu = torch.log(torch.rand(C, generator=gen, device=dev))
    row = asis.asis_stats(beta, mu, g, h)
    th_new, aux, beta_new = asis.asis_propose(row, mu, lt, eps, scale, beta,
                                              PRIOR)
    v_new, g_new = logistic_logp_grad(beta_new, x, y, m)
    return dict(beta=beta, mu=mu, lt=lt, g=g, h=h, v=v, scale=scale,
                eps=eps, logu=logu, row=row, th_new=th_new, aux=aux,
                v_new=v_new, g_new=g_new)


@pytest.mark.parametrize("laplace", [True, False])
@pytest.mark.parametrize("p", [3, 4])
def test_each_wrapper_matches_its_plain_version(dev, laplace, p):
    C, G = 130, 300
    a = _inputs(dev, C, G, p, laplace)
    row = asis.asis_stats(a["beta"], a["mu"], a["g"], a["h"])
    torch.testing.assert_close(
        row, asis.asis_stats_plain(a["beta"], a["mu"], a["g"], a["h"]),
        rtol=1e-4, atol=1e-3)
    vv = (a["v_new"], a["v"])
    row_new = asis.asis_stats(a["beta"], a["mu"], a["g_new"], a["h"],
                              a["aux"], vv)
    torch.testing.assert_close(
        row_new, asis.asis_stats_plain(a["beta"], a["mu"], a["g_new"],
                                       a["h"], a["aux"], vv),
        rtol=1e-4, atol=1e-3)
    args = (row, a["mu"], a["lt"], a["eps"], a["scale"], a["beta"], PRIOR)
    for k, w in zip(asis.asis_propose(*args), asis.asis_propose_plain(*args)):
        torch.testing.assert_close(k, w, **TOL)
    args = (row_new, a["th_new"], a["mu"], a["lt"], a["aux"], a["scale"],
            a["logu"], PRIOR)
    la, acc, alpha = asis.asis_accept(*args)
    w_la, w_acc, w_alpha = asis.asis_accept_plain(*args)
    torch.testing.assert_close(la, w_la, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(alpha, w_alpha, **ALPHA_TOL)
    clear = (w_la - a["logu"]).abs() > DECIDE_TOL
    assert torch.equal(acc[clear], w_acc[clear])
    assert torch.equal(acc, a["logu"] < la)


def test_a_chain_slice_is_bitwise_the_full_launch(dev):
    """A chain shard's launches (chains 40..129 of 130) give bitwise the
    full launch's rows, proposal and decision for its chains."""
    C, G, p = 130, 300, 4
    a = _inputs(dev, C, G, p, laplace=True)
    sl = slice(40, C)

    def cut(t):
        return None if t is None else t[sl].contiguous()
    full = asis.asis_stats(a["beta"], a["mu"], a["g"], a["h"])
    part = asis.asis_stats(cut(a["beta"]), cut(a["mu"]), cut(a["g"]),
                           cut(a["h"]))
    assert torch.equal(part, full[sl])
    fp = asis.asis_propose(full, a["mu"], a["lt"], a["eps"], None,
                           a["beta"], PRIOR)
    pp = asis.asis_propose(part, cut(a["mu"]), cut(a["lt"]), cut(a["eps"]),
                           None, cut(a["beta"]), PRIOR)
    for f, q in zip(fp, pp):
        assert torch.equal(q, f[sl])
    fa = asis.asis_accept(full, fp[0], a["mu"], a["lt"], fp[1], None,
                          a["logu"], PRIOR)
    pa = asis.asis_accept(part, pp[0], cut(a["mu"]), cut(a["lt"]), pp[1],
                          None, cut(a["logu"]), PRIOR)
    for f, q in zip(fa, pa):
        assert torch.equal(q, f[sl])


def test_a_group_slice_sums_to_the_full_rows(dev):
    """Two group shards (groups 0..109 and 110..299): their rows add up to
    the full launch's (float32 sums in another order), and a shard's
    proposal from the full rows is bitwise the full launch's groups."""
    C, G, p = 130, 300, 3
    a = _inputs(dev, C, G, p, laplace=False)
    g1 = 110
    vv = (a["v_new"], a["v"])

    def rows(lo, hi):
        return asis.asis_stats(
            a["beta"][:, lo:hi].contiguous(), a["mu"],
            a["g_new"][:, lo:hi].contiguous(), a["h"][:, lo:hi].contiguous(),
            a["aux"], tuple(t[:, lo:hi].contiguous() for t in vv))
    full = asis.asis_stats(a["beta"], a["mu"], a["g_new"], a["h"], a["aux"],
                           vv)
    torch.testing.assert_close(rows(0, g1) + rows(g1, G), full, rtol=1e-4,
                               atol=1e-3)
    th, aux, bn = asis.asis_propose(a["row"], a["mu"], a["lt"], a["eps"],
                                    a["scale"], a["beta"], PRIOR)
    th2, aux2, bn2 = asis.asis_propose(
        a["row"], a["mu"], a["lt"], a["eps"], a["scale"],
        a["beta"][:, g1:].contiguous(), PRIOR)
    assert torch.equal(th2, th) and torch.equal(aux2, aux)
    assert torch.equal(bn2, bn[:, g1:])


@pytest.mark.parametrize("where", ["current", "proposal"])
def test_a_planted_non_pd_metric_rejects_with_alpha_zero(dev, where):
    C, G, p = 130, 300, 4
    a = _inputs(dev, C, G, p, laplace=True)
    h_bad = -a["h"]
    row = asis.asis_stats(a["beta"], a["mu"], a["g"],
                          h_bad if where == "current" else a["h"])
    th_new, aux, _ = asis.asis_propose(row, a["mu"], a["lt"], a["eps"], None,
                                       a["beta"], PRIOR)
    row_new = asis.asis_stats(a["beta"], a["mu"], a["g_new"], h_bad, aux,
                              (a["v_new"], a["v"]))
    la, acc, alpha = asis.asis_accept(row_new, th_new, a["mu"], a["lt"], aux,
                                      None, torch.full_like(a["logu"], -50.0),
                                      PRIOR)
    assert bool(torch.isnan(la).all())
    assert not bool(acc.any())
    assert bool((alpha == 0).all())


def test_two_calls_give_the_same_bits(dev):
    """No atomics: the sums over groups, the proposal and the decision
    repeat their bits, at a mala rank's group count (wide blocks)."""
    C, G, p = 64, 50_000, 3
    a = _inputs(dev, C, G, p, laplace=False)
    vv = (a["v_new"], a["v"])
    calls = [
        lambda: (asis.asis_stats(a["beta"], a["mu"], a["g_new"], a["h"],
                                 a["aux"], vv),),
        lambda: asis.asis_propose(a["row"], a["mu"], a["lt"], a["eps"],
                                  a["scale"], a["beta"], PRIOR),
        lambda: asis.asis_accept(a["row"], a["th_new"], a["mu"], a["lt"],
                                 a["aux"], a["scale"], a["logu"], PRIOR),
    ]
    for call in calls:
        first, second = call(), call()
        for s, t in zip(first, second):
            assert torch.equal(s, t)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_the_library_row_width_is_the_wrappers(dev, p):
    assert _build.library(p).nestmc_asis_row() == asis.row_width(p)
