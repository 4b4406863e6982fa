"""The CUDA kernels vs their plain versions, on the card.

Marked ``cuda``; each test skips itself when torch finds no CUDA device.
Run on a GPU host: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Small shapes with a ragged chain tile (C=130 over 128-thread blocks) and a
masked tail. Tolerances: obs passes and step outputs |a - b| <= 1e-4 +
1e-4 |b| (float32 sums in another order); accept decisions may differ only
where |log alpha - log u| < 1e-3.
"""

import math

import pytest
import torch

from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.diagnostics import fold_rhat_scalars
from nestmc_torch.kernels.gibbs import make_sweep
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.models import (
    make_hier_logistic,
    make_nested_poisson,
    synth_logistic,
    synth_poisson3,
)
from nestmc_torch.ops import loglik
from nestmc_torch.ops.cuda import loglik_poisson as pois
from nestmc_torch.ops.cuda import poisson_accept as pacc
from nestmc_torch.ops.cuda import LAUNCHES, reset_launch_counts
from nestmc_torch.ops.cuda.loglik_logistic import (
    logistic_loglik,
    logistic_logp_grad,
    logistic_logp_grad_hess,
)
from nestmc_torch.ops.cuda.mala_accept import (
    fused_mala_logistic_step,
    fused_mala_logistic_step_plain,
)
from nestmc_torch.ops.cuda.mh_accept import (
    fused_rwmh_logistic_step,
    fused_rwmh_logistic_step_plain,
)
from nestmc_torch.ops.cuda.newton_accept import (
    fused_newton_logistic_step,
    fused_newton_logistic_step_plain,
    philox_probe,
)
from nestmc_torch.ops import bucket
from nestmc_torch.ops.cuda.loglik_segment import (
    logistic_logp_grad_segment,
    logistic_logp_grad_segment_plain,
    logistic_loglik_segment,
    logistic_loglik_segment_plain,
)
from nestmc_torch.ops.segment import SegmentLayout
from nestmc_torch.rng import SweepRNG
# a sibling module by its own name: the card's host may have another
# package called tests on its path
from _torch_steps import STEPS, cut_inputs, run_step, step_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, C=130, G=9, n=13, p=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(G, n, p, generator=g)
    x[:, :, 0] = 1.0
    mask = torch.ones(G, n)
    mask[0, n - 4:] = 0.0
    y = (torch.rand(G, n, generator=g) < 0.5).float() * mask
    beta = 0.5 * torch.randn(C, G, p, generator=g)
    mu = 0.3 * torch.randn(C, p, generator=g)
    lt = -0.5 + 0.2 * torch.randn(C, p, generator=g)
    eps = torch.randn(C, G, p, generator=g)
    logu = torch.log(torch.rand(C, G, generator=g))
    return [t.to(dev) for t in (beta, x, y, mask, mu, lt, eps, logu)]


def _assert_close(a, b, what):
    err = (a - b).abs()
    bound = 1e-4 + 1e-4 * b.abs()
    assert bool((err <= bound).all()), (what, float(err.max()))


@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_obs_pass_kernels_match_plain(dev, p):
    beta, x, y, mask = _inputs(dev, p=p)[:4]
    reset_launch_counts()
    for kern, plain, key in (
        (lambda *a: (logistic_loglik(*a),),
         lambda *a: (loglik.logistic_loglik_padded(*a),), "loglik"),
        (logistic_logp_grad, loglik.logistic_logp_grad_padded, "logp_grad"),
        (logistic_logp_grad_hess, loglik.logistic_logp_grad_hess_padded,
         "logp_grad_hess"),
    ):
        out, ref = kern(beta, x, y, mask), plain(beta, x, y, mask)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            _assert_close(a, b, key)
        assert LAUNCHES[key] == 1


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("frozen", [False, True])
def test_newton_kernel_matches_plain(dev, frozen, fold):
    beta, x, y, mask, mu, lt, eps, logu = _inputs(dev)
    C, G, p = beta.shape
    v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, mask)
    ls = torch.zeros(C, G, device=dev)
    rhat_fold = None
    if fold:
        rhat_fold = (torch.randn(2, G, p, C, device=dev),
                     torch.rand(2, G, p, C, device=dev),
                     fold_rhat_scalars([3.0, 0.0], 3, 5))
    args = (beta, v, g, h, ls, mu, lt, x, y, mask)
    out = fused_newton_logistic_step(*args, noise=(eps, logu), frozen=frozen,
                                     rhat_fold=rhat_fold)
    ref = fused_newton_logistic_step_plain(*args, (eps, logu), frozen=frozen,
                                           rhat_fold=rhat_fold)
    torch.cuda.synchronize()
    acc_k = (out[0] != beta).any(-1)
    acc_p = (ref[0] != beta).any(-1)
    la = torch.log(ref[4])
    assert bool(((acc_k == acc_p) | ((la - logu).abs() < 1e-3)).all())
    same = acc_k == acc_p
    for i in range(len(out)):
        if i == 3 and frozen:
            assert out[3] is h
            continue
        a, b = out[i], ref[i]
        if i < 5:
            m = same if a.dim() == 2 else same[..., None]
            a, b = a[m.expand_as(a)], b[m.expand_as(b)]
        _assert_close(a, b, f"output {i}")


def _check_step(out, ref, beta, logu, alpha_i):
    """Accept decisions agree except within |log alpha - log u| < 1e-3;
    every output agrees on the cells whose decisions agree."""
    acc_k = (out[0] != beta).any(-1)
    acc_p = (ref[0] != beta).any(-1)
    la = torch.log(ref[alpha_i])
    assert bool(((acc_k == acc_p) | ((la - logu).abs() < 1e-3)).all())
    same = acc_k == acc_p
    for i in range(len(out)):
        a, b = out[i], ref[i]
        if i <= alpha_i:
            m = same if a.dim() == 2 else same[..., None]
            a, b = a[m.expand_as(a)], b[m.expand_as(b)]
        _assert_close(a, b, f"output {i}")


@pytest.mark.parametrize("fold", [False, True])
def test_mala_kernel_matches_plain(dev, fold):
    beta, x, y, mask, mu, lt, eps, logu = _inputs(dev, p=3)
    C, G, p = beta.shape
    v, g = loglik.logistic_logp_grad_padded(beta, x, y, mask)
    ls = torch.full((C, 1), -1.3, device=dev)
    rhat_fold = None
    if fold:
        rhat_fold = (torch.randn(2, G, p, C, device=dev),
                     torch.rand(2, G, p, C, device=dev),
                     fold_rhat_scalars([3.0, 0.0], 3, 5))
    reset_launch_counts()
    args = (beta, v, g, ls, mu, lt, x, y, mask)
    out = fused_mala_logistic_step(*args, noise=(eps, logu),
                                   rhat_fold=rhat_fold)
    ref = fused_mala_logistic_step_plain(
        *args[:3], ls.expand(C, G), *args[4:], (eps, logu),
        rhat_fold=rhat_fold)
    torch.cuda.synchronize()
    assert LAUNCHES["mala_step"] == 1
    assert 0.05 < float(ref[3].mean()) < 0.999
    _check_step(out, ref, beta, logu, 3)


def test_rwmh_kernel_matches_plain(dev):
    beta, x, y, mask, mu, lt, eps, logu = _inputs(dev)
    C, G, p = beta.shape
    lik = loglik.logistic_loglik_padded(beta, x, y, mask)
    ls = torch.full((C, G), -1.6, device=dev)
    reset_launch_counts()
    args = (beta, lik, ls, mu, lt, x, y, mask)
    out = fused_rwmh_logistic_step(*args, noise=(eps, logu))
    ref = fused_rwmh_logistic_step_plain(*args, (eps, logu))
    torch.cuda.synchronize()
    assert LAUNCHES["rwmh_step"] == 1
    assert 0.05 < float(ref[2].mean()) < 0.999
    _check_step(out, ref, beta, logu, 2)


def test_step_kernels_philox_path(dev):
    """The in-kernel noise path of the MALA and RW steps launches and stays
    finite, with a plausible acceptance."""
    beta, x, y, mask, mu, lt = _inputs(dev, p=3)[:6]
    C, G, _ = beta.shape
    v, g = loglik.logistic_logp_grad_padded(beta, x, y, mask)
    rng = SweepRNG(0, dev)
    out = fused_mala_logistic_step(beta, v, g, torch.full((C, G), -1.3,
                                                          device=dev),
                                   mu, lt, x, y, mask, rng=rng)
    out2 = fused_rwmh_logistic_step(beta, v, torch.full((C, 1), -1.6,
                                                        device=dev),
                                    mu, lt, x, y, mask, rng=rng)
    torch.cuda.synchronize()
    for o in (out, out2):
        assert all(bool(torch.isfinite(t).all()) for t in o)
        assert 0.1 < float(o[-1].mean()) <= 1.0


def test_newton_kernel_philox_path(dev):
    """The in-kernel noise path launches, counts and stays finite."""
    beta, x, y, mask, mu, lt = _inputs(dev)[:6]
    v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, mask)
    ls = torch.zeros(beta.shape[:2], device=dev)
    reset_launch_counts()
    rng = SweepRNG(0, dev)
    for frozen in (False, True):
        out = fused_newton_logistic_step(beta, v, g, h, ls, mu, lt, x, y,
                                         mask, rng=rng, frozen=frozen)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in out)
        assert 0.5 < float(out[4].mean()) <= 1.0
    assert LAUNCHES["newton_step_refresh"] == LAUNCHES["newton_step_frozen"] == 1


def test_philox_moments(dev):
    nrm, uni = philox_probe(512 * 256, (1234, 99), dev)
    x = nrm.double().cpu()
    n = x.numel()
    assert abs(float(x.mean())) < 4 / math.sqrt(n)
    assert abs(float(x.std()) - 1.0) < 4 / math.sqrt(2 * n)
    assert abs(float((x.abs() > 2.0).double().mean()) - 0.0455) < 0.01
    assert abs(float((x**3).mean())) < 6 * math.sqrt(15 / n)
    u = uni.double().cpu()
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert abs(float(u.mean()) - 0.5) < 4 * math.sqrt(1 / 12 / n)


def test_default_config_sweep_launches_kernels(dev):
    """A sweep built from the default KernelConfig (fused_accept off) runs
    the CUDA Newton kernel in both phases, and the obs-pass kernels."""
    data, _ = synth_logistic(4, G=9, n=13, p=3, device=dev)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(kernel=KernelConfig(algorithm="newton"),
                        run=RunConfig(chains=130, log_every_segment=False))
    rng = SweepRNG(0, dev)
    reset_launch_counts()
    state = init_kernel_state(model, cfg, rng, data)
    sweep = make_sweep(model, cfg)
    state = sweep(state, data, True, rng)
    state = sweep(state, data, False, rng)
    torch.cuda.synchronize()
    assert LAUNCHES["newton_step_refresh"] == 1
    assert LAUNCHES["newton_step_frozen"] == 1
    assert LAUNCHES["logp_grad_hess"] == 2   # init cache + warmup ASIS eval
    assert LAUNCHES["logp_grad"] == 1        # sampling ASIS eval
    assert all(bool(torch.isfinite(v).all()) for v in state.position.values())


@pytest.mark.parametrize("algorithm", ["mala", "rwmh"])
def test_default_config_mala_rw_sweeps_launch_kernels(dev, algorithm):
    """A default-config MALA or RW-MH sweep (half-normal tau) runs its
    fused step and its obs-pass kernel on the card in both phases."""
    data, _ = synth_logistic(4, G=9, n=13, p=3, device=dev)
    model = make_hier_logistic(data)
    cfg = SamplerConfig(kernel=KernelConfig(algorithm=algorithm),
                        run=RunConfig(chains=130, log_every_segment=False))
    rng = SweepRNG(0, dev)
    reset_launch_counts()
    state = init_kernel_state(model, cfg, rng, data)
    sweep = make_sweep(model, cfg)
    state = sweep(state, data, True, rng)
    state = sweep(state, data, False, rng)
    torch.cuda.synchronize()
    step, obs = (("mala_step", "logp_grad") if algorithm == "mala"
                 else ("rwmh_step", "loglik"))
    assert LAUNCHES[step] == 2
    assert LAUNCHES[obs] == 3          # init cache + one move eval a sweep
    assert sum(LAUNCHES.values()) == 5
    assert all(bool(torch.isfinite(v).all()) for v in state.position.values())


def _pois_inputs(dev, C=130, G=5, spg=3, n=11, p=3, seed=1):
    """Nested Poisson data (a masked tail on subject 0), a spread-out
    beta_s, per-subject prior means, log tau_s and external noise."""
    data, _ = synth_poisson3(seed, G=G, subjects_per_group=spg, n=n, p=p,
                             device=dev)
    mask = data.mask.clone()
    mask[0, n - 4:] = 0.0
    y = data.y * mask
    S = G * spg
    g = torch.Generator().manual_seed(seed)
    beta = 0.3 * torch.randn(C, S, p, generator=g)
    bgs = beta + 0.2 * torch.randn(C, S, p, generator=g)
    lts = -1.2 + 0.2 * torch.randn(C, p, generator=g)
    eps = torch.randn(C, S, p, generator=g)
    logu = torch.log(torch.rand(C, S, generator=g))
    return [data.x, y, mask] + [t.to(dev) for t in (beta, bgs, lts, eps,
                                                    logu)]


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_poisson_obs_pass_kernels_match_plain(dev, p):
    x, y, mask, beta = _pois_inputs(dev, p=p)[:4]
    const = loglik.poisson_const(y, mask)
    reset_launch_counts()
    for kern, plain, key in (
        (lambda *a, **k: (pois.poisson_loglik(*a, **k),),
         lambda *a, **k: (loglik.poisson_loglik_padded(*a, **k),),
         "pois_loglik"),
        (pois.poisson_logp_grad, loglik.poisson_logp_grad_padded,
         "pois_logp_grad"),
        (pois.poisson_logp_grad_hess, loglik.poisson_logp_grad_hess_padded,
         "pois_logp_grad_hess"),
    ):
        for c in (None, const):
            out = kern(beta, x, y, mask, const=c)
            ref = plain(beta, x, y, mask, const=c)
            torch.cuda.synchronize()
            for a, b in zip(out, ref):
                _assert_close(a, b, key)
        assert LAUNCHES[key] == 2
    assert sum(LAUNCHES.values()) == 6


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton", "frozen"])
def test_poisson_step_kernels_match_plain(dev, algorithm):
    x, y, mask, beta, bgs, lts, eps, logu = _pois_inputs(dev)
    C, S, p = beta.shape
    v, g, h = loglik.poisson_logp_grad_hess_padded(beta, x, y, mask)
    noise = (eps, logu)
    reset_launch_counts()
    if algorithm == "rwmh":
        ls = torch.full((C, S), -1.8, device=dev)
        args = (beta, v, ls, bgs, lts, x, y, mask)
        out = pacc.fused_rwmh_poisson_step(*args, noise=noise)
        ref = pacc.fused_rwmh_poisson_step_plain(*args, noise)
        key, alpha_i = "pois_rwmh_step", 2
    elif algorithm == "mala":
        ls = torch.full((C, 1), -1.5, device=dev)
        args = (beta, v, g, ls, bgs, lts, x, y, mask)
        out = pacc.fused_mala_poisson_step(*args, noise=noise)
        ref = pacc.fused_mala_poisson_step_plain(
            *args[:3], ls.expand(C, S), *args[4:], noise)
        key, alpha_i = "pois_mala_step", 3
    else:
        frozen = algorithm == "frozen"
        ls = torch.zeros(C, S, device=dev)
        args = (beta, v, g, h, ls, bgs, lts, x, y, mask)
        out = pacc.fused_newton_poisson_step(*args, noise=noise,
                                             frozen=frozen)
        ref = pacc.fused_newton_poisson_step_plain(*args, noise,
                                                   frozen=frozen)
        key = ("pois_newton_step_frozen" if frozen
               else "pois_newton_step_refresh")
        alpha_i = 4
        if frozen:
            assert out[3] is h
            out, ref = out[:3] + out[4:], ref[:3] + ref[4:]
            alpha_i = 3
    torch.cuda.synchronize()
    assert LAUNCHES[key] == 1 and sum(LAUNCHES.values()) == 1
    assert 0.05 < float(ref[alpha_i].mean()) <= 1.0
    _check_step(out, ref, beta, logu, alpha_i)


def test_poisson_step_kernels_reject_nan_proposals(dev):
    x, y, mask, beta, bgs, lts, eps, logu = _pois_inputs(dev)
    C, S, p = beta.shape
    v, g, h = loglik.poisson_logp_grad_hess_padded(beta, x, y, mask)
    noise = (torch.full_like(eps, float("nan")), logu)
    ls = torch.zeros(C, S, device=dev)
    outs = (
        pacc.fused_rwmh_poisson_step(beta, v, ls, bgs, lts, x, y, mask,
                                     noise=noise),
        pacc.fused_mala_poisson_step(beta, v, g, ls, bgs, lts, x, y, mask,
                                     noise=noise),
        pacc.fused_newton_poisson_step(beta, v, g, h, ls, bgs, lts, x, y,
                                       mask, noise=noise),
    )
    torch.cuda.synchronize()
    for out in outs:
        assert bool((out[-1] == 0.0).all())
        assert torch.equal(out[0], beta) and torch.equal(out[1], v)


def test_poisson_step_kernels_philox_path(dev):
    """The in-kernel noise path of the three Poisson steps launches and
    stays finite with a plausible acceptance; at a tiny RW scale (every
    proposal accepted) the moves (new - beta) / s are its normals."""
    x, y, mask, beta, bgs, lts = _pois_inputs(dev, C=1024)[:6]
    C, S, p = beta.shape
    v, g, h = loglik.poisson_logp_grad_hess_padded(beta, x, y, mask)
    rng = SweepRNG(0, dev)
    ls = torch.full((C, S), -1.5, device=dev)
    reset_launch_counts()
    outs = [
        pacc.fused_rwmh_poisson_step(beta, v, ls, bgs, lts, x, y, mask,
                                     rng=rng),
        pacc.fused_mala_poisson_step(beta, v, g, ls, bgs, lts, x, y, mask,
                                     rng=rng),
    ]
    for frozen in (False, True):
        outs.append(pacc.fused_newton_poisson_step(
            beta, v, g, h, torch.zeros(C, S, device=dev), bgs, lts, x, y,
            mask, rng=rng, frozen=frozen))
    torch.cuda.synchronize()
    for o in outs:
        assert all(bool(torch.isfinite(t).all()) for t in o)
        assert 0.1 < float(o[-1].mean()) <= 1.0
    for k in ("pois_rwmh_step", "pois_mala_step", "pois_newton_step_refresh",
              "pois_newton_step_frozen"):
        assert LAUNCHES[k] == 1, k
    tiny = torch.full((C, S), -8.0, device=dev)
    out = pacc.fused_rwmh_poisson_step(beta, v, tiny, bgs, lts, x, y, mask,
                                       rng=rng)
    torch.cuda.synchronize()
    assert float(out[2].mean()) > 0.99
    z = ((out[0] - beta) / torch.exp(tiny)[..., None]).double().cpu()
    z = z[(out[0] != beta).any(-1).cpu()].ravel()
    n = z.numel()
    assert n > 0.95 * C * S * p
    assert abs(float(z.mean())) < 4 / math.sqrt(n)
    assert abs(float(z.std()) - 1.0) < 4 / math.sqrt(2 * n)


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton"])
def test_default_config_poisson_sweeps_launch_kernels(dev, algorithm):
    """A default-config nested Poisson sweep (invgamma) runs its fused
    subject step and its obs-pass kernel on the card in both phases, the
    noise fill of its conjugate beta_g draw once a sweep, and no logistic
    kernel."""
    data, _ = synth_poisson3(4, G=7, subjects_per_group=3, n=9, p=3,
                             device=dev)
    model = make_nested_poisson(data, tau_prior="invgamma")
    cfg = SamplerConfig(kernel=KernelConfig(algorithm=algorithm),
                        run=RunConfig(chains=130, log_every_segment=False))
    rng = SweepRNG(0, dev)
    reset_launch_counts()
    state = init_kernel_state(model, cfg, rng, data)
    sweep = make_sweep(model, cfg)
    state = sweep(state, data, True, rng)
    state = sweep(state, data, False, rng)
    torch.cuda.synchronize()
    want = {
        "rwmh": {"pois_rwmh_step": 2, "pois_loglik": 5},
        "mala": {"pois_mala_step": 2, "pois_logp_grad": 5},
        "newton": {"pois_newton_step_refresh": 1,
                   "pois_newton_step_frozen": 1,
                   "pois_logp_grad_hess": 3, "pois_logp_grad": 2},
    }[algorithm] | {"philox_fill": 2}
    assert {k: v for k, v in LAUNCHES.items() if v} == want
    assert all(bool(torch.isfinite(v).all()) for v in state.position.values())


def _ragged_inputs(dev, C, G, p, sizes, seed=2):
    """Flat ragged data with the given group sizes and a beta (C, G, p)."""
    g = torch.Generator().manual_seed(seed)
    seg = torch.repeat_interleave(torch.arange(G), torch.as_tensor(sizes))
    N = seg.numel()
    x = torch.randn(N, p, generator=g)
    y = (torch.rand(N, generator=g) < 0.5).float()
    beta = 0.7 * torch.randn(C, G, p, generator=g)
    layout = SegmentLayout.build(seg, G, device=dev)
    return beta.to(dev), x.to(dev), y.to(dev), layout


@pytest.mark.parametrize("case", [
    # (C, G, p, sizes): empty groups at a ragged chain tile; one group
    # larger than the kernel's 256-observation chunk; every group empty
    (130, 37, 3, [0, 5, 12, 1, 0] * 7 + [3, 0]),
    (64, 6, 4, [700, 0, 3, 257, 256, 1]),
    (8, 4, 2, [0, 0, 0, 0]),
    (200, 50, 8, [i % 9 for i in range(50)]),
])
def test_segment_kernels_match_plain(dev, case):
    """Loglik |a-b| <= 2e-5 + 2e-5|b|, gradient <= 2e-5 + 2e-4|b| (the
    reference's segment contract); empty groups give exactly 0."""
    C, G, p, sizes = case
    beta, x, y, layout = _ragged_inputs(dev, C, G, p, sizes)
    reset_launch_counts()
    v = logistic_loglik_segment(beta, x, y, layout)
    vg, g = logistic_logp_grad_segment(beta, x, y, layout)
    rv = logistic_loglik_segment_plain(beta, x, y, layout)
    rvg, rg = logistic_logp_grad_segment_plain(beta, x, y, layout)
    torch.cuda.synchronize()
    assert LAUNCHES["seg_loglik"] == LAUNCHES["seg_logp_grad"] == 1
    assert sum(LAUNCHES.values()) == 2
    for a, b, rtol in ((v, rv, 2e-5), (vg, rvg, 2e-5), (g, rg, 2e-4)):
        assert bool(((a - b).abs() <= 2e-5 + rtol * b.abs()).all()), \
            float((a - b).abs().max())
    empty = torch.as_tensor(sizes, device=dev) == 0
    assert bool((v[:, empty] == 0).all() and (g[:, empty] == 0).all())


def test_segment_wrappers_check_their_inputs(dev):
    beta, x, y, layout = _ragged_inputs(dev, 8, 5, 3, [2, 3, 0, 1, 4])
    with pytest.raises(ValueError):
        logistic_loglik_segment(beta[:, :4].contiguous(), x, y, layout)
    with pytest.raises(ValueError):
        logistic_logp_grad_segment(beta, x[:-1], y, layout)
    cpu_layout = SegmentLayout.build(layout.segment_ids.cpu(), 5)
    with pytest.raises(ValueError):
        logistic_loglik_segment(beta, x, y, cpu_layout)


def _bucket_inputs(dev, C=130, G=90, n=32, seed=6):
    data, _ = synth_logistic(seed, G=G, n=n, p=3, ragged=True, min_obs=1,
                             device=dev)
    layout = bucket.BucketLayout.build(data.segment_ids, G, x=data.x,
                                       y=data.y)
    assert len(layout.buckets) > 1 and bucket.covers_all_groups(layout)
    g = torch.Generator().manual_seed(seed)
    beta = 0.5 * torch.randn(C, G, 3, generator=g)
    mu = 0.3 * torch.randn(C, 3, generator=g)
    lt = -0.5 + 0.2 * torch.randn(C, 3, generator=g)
    eps = torch.randn(C, G, 3, generator=g)
    logu = torch.log(torch.rand(C, G, generator=g))
    return data, layout, [t.to(dev) for t in (beta, mu, lt, eps, logu)]


@pytest.mark.parametrize("algorithm", ["mala", "newton", "frozen"])
def test_bucketed_steps_match_plain(dev, algorithm):
    """The bucketed fused steps with external noise: one kernel launch per
    bucket on the card, against the same bucketed step on CPU copies (the
    plain versions), accept decisions and outputs as _check_step."""
    data, layout, (beta, mu, lt, eps, logu) = _bucket_inputs(dev)
    C, G, p = beta.shape
    B = len(layout.buckets)
    cpu_layout = bucket.BucketLayout.build(
        data.segment_ids.cpu(), G, x=data.x.cpu(), y=data.y.cpu())
    v, g, h = bucket.bucketed_logistic_logp_grad_hess(beta, layout)
    noise = (eps, logu)

    def run(lay, *args, **kw):
        if algorithm == "mala":
            return bucket.bucketed_fused_mala_step(
                *args[:3], torch.full((C, 1), -1.3, device=args[0].device),
                *args[4:6], lay, noise=kw["noise"])
        return bucket.bucketed_fused_newton_step(
            *args[:4], torch.zeros(C, G, device=args[0].device), *args[4:6],
            lay, noise=kw["noise"], frozen=algorithm == "frozen")

    reset_launch_counts()
    out = run(layout, beta, v, g, h, mu, lt, noise=noise)
    torch.cuda.synchronize()
    key = {"mala": "mala_step", "newton": "newton_step_refresh",
           "frozen": "newton_step_frozen"}[algorithm]
    assert LAUNCHES[key] == B and sum(LAUNCHES.values()) == B
    ref = list(run(cpu_layout, *(t.cpu() for t in (beta, v, g, h, mu, lt)),
                   noise=tuple(t.cpu() for t in noise)))
    alpha_i = 3 if algorithm == "mala" else 4
    if algorithm == "frozen":
        assert out[3] is h
        out, ref, alpha_i = out[:3] + out[4:], ref[:3] + ref[4:], 3
    out = [o.cpu() for o in out]
    assert 0.05 < float(ref[alpha_i].mean()) <= 1.0
    _check_step(out, ref, beta.cpu(), logu.cpu(), alpha_i)


def test_ragged_sweeps_launch_their_kernels(dev):
    """One warmup and one sampling sweep of config 4's two routes: the
    bucket route runs B Newton launches and B Hessian or gradient passes a
    sweep; the segment route's MALA and RW-MH run the segment kernel and
    the noise fill of beta's unfused update (proposal and accept draws)."""
    data, _ = synth_logistic(4, G=90, n=32, p=3, ragged=True, min_obs=1,
                             device=dev)
    for impl, algorithm, tau in (("auto", "newton", "invgamma"),
                                 ("pallas-segment", "mala", "halfnormal"),
                                 ("pallas-segment", "rwmh", "halfnormal")):
        model = make_hier_logistic(data, loglik_impl=impl, tau_prior=tau)
        cfg = SamplerConfig(kernel=KernelConfig(algorithm=algorithm),
                            run=RunConfig(chains=130,
                                          log_every_segment=False))
        rng = SweepRNG(0, dev)
        reset_launch_counts()
        state = init_kernel_state(model, cfg, rng, data)
        sweep = make_sweep(model, cfg)
        state = sweep(state, data, True, rng)
        state = sweep(state, data, False, rng)
        torch.cuda.synchronize()
        if impl == "auto":
            B = len(bucket.BucketLayout.build(data.segment_ids, 90).buckets)
            want = {"newton_step_refresh": B, "newton_step_frozen": B,
                    "logp_grad_hess": 2 * B, "logp_grad": B}
        else:
            want = {"seg_logp_grad" if algorithm == "mala"
                    else "seg_loglik": 5, "philox_fill": 4}
        assert {k: n for k, n in LAUNCHES.items() if n} == want
        assert all(bool(torch.isfinite(t).all())
                   for t in state.position.values())


# ---- the tiled templates (csrc/cell_tile.cuh): logp_grad_kernel and
# mala_step_kernel at partial tiles and odd sizes. (C, G, n): one chain,
# G below a tile, ragged tiles on both axes, a single observation.
TILE_CASES = [(1, 1, 1), (33, 31, 13), (130, 33, 50), (1, 70, 13),
              (33, 70, 1), (130, 1, 50)]


def _tile_inputs(dev, C, G, n, p, seed=3, sparse=False):
    """Logistic and Poisson data with masked rows (unit 0's tail, unit 5's
    first half; ``sparse``: all but every 100th row), beta, priors and
    external noise."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(G, n, p, generator=g)
    x[:, :, 0] = 1.0
    mask = torch.ones(G, n)
    mask[0, max(n - 4, 0):] = 0.0
    if G > 5:
        mask[5, : n // 2] = 0.0
    if sparse:
        mask.zero_()
        mask[:, ::100] = 1.0
    y = (torch.rand(G, n, generator=g) < 0.5).float() * mask
    ypo = torch.poisson(torch.full((G, n), 1.5), generator=g) * mask
    beta = 0.5 * torch.randn(C, G, p, generator=g)
    bpo = 0.3 * torch.randn(C, G, p, generator=g)
    bgs = bpo + 0.2 * torch.randn(C, G, p, generator=g)
    mu = 0.3 * torch.randn(C, p, generator=g)
    lt = -0.5 + 0.2 * torch.randn(C, p, generator=g)
    lts = -1.2 + 0.2 * torch.randn(C, p, generator=g)
    eps = torch.randn(C, G, p, generator=g)
    logu = torch.log(torch.rand(C, G, generator=g))
    fold = (torch.randn(2, G, p, C, generator=g),
            torch.rand(2, G, p, C, generator=g))
    names = ("x", "mask", "y", "ypo", "beta", "bpo", "bgs", "mu", "lt", "lts",
             "eps", "logu")
    vals = (x, mask, y, ypo, beta, bpo, bgs, mu, lt, lts, eps, logu)
    r = {k: t.to(dev) for k, t in zip(names, vals)}
    r["fold"] = tuple(t.to(dev) for t in fold) + (
        fold_rhat_scalars([3.0, 0.0], 3, 5),)
    r["const"] = loglik.poisson_const(r["ypo"], r["mask"])
    return r


def _tiled_obs_passes(r):
    """Logit and Poisson logp_grad and logp_grad_hess: kernel vs plain."""
    x, m, y, ypo, const = r["x"], r["mask"], r["y"], r["ypo"], r["const"]
    reset_launch_counts()
    for kern, plain, a in (
        (logistic_logp_grad, loglik.logistic_logp_grad_padded,
         (r["beta"], x, y, m)),
        (logistic_logp_grad_hess, loglik.logistic_logp_grad_hess_padded,
         (r["beta"], x, y, m)),
        (pois.poisson_logp_grad, loglik.poisson_logp_grad_padded,
         (r["bpo"], x, ypo, m, const)),
        (pois.poisson_logp_grad_hess, loglik.poisson_logp_grad_hess_padded,
         (r["bpo"], x, ypo, m, const)),
    ):
        out, ref = kern(*a), plain(*a)
        torch.cuda.synchronize()
        for o, f in zip(out, ref):
            _assert_close(o, f, kern.__name__)
    assert {k: n for k, n in LAUNCHES.items() if n} == {
        "logp_grad": 1, "logp_grad_hess": 1, "pois_logp_grad": 1,
        "pois_logp_grad_hess": 1}


def _tiled_mala_steps(r):
    """The Logit MALA step without and with the fold and the Poisson one,
    external noise: kernel vs plain."""
    x, m, y, ypo, const = r["x"], r["mask"], r["y"], r["ypo"], r["const"]
    beta, bpo = r["beta"], r["bpo"]
    C, G, _ = beta.shape
    noise = (r["eps"], r["logu"])
    v, g = loglik.logistic_logp_grad_padded(beta, x, y, m)
    ls = torch.full((C, 1), -1.3, device=beta.device)
    reset_launch_counts()
    for rf in (None, r["fold"]):
        out = fused_mala_logistic_step(beta, v, g, ls, r["mu"], r["lt"], x,
                                       y, m, noise=noise, rhat_fold=rf)
        ref = fused_mala_logistic_step_plain(
            beta, v, g, ls.expand(C, G), r["mu"], r["lt"], x, y, m, noise,
            rhat_fold=rf)
        torch.cuda.synchronize()
        _check_step(out, ref, beta, r["logu"], 3)
    vp, gp = loglik.poisson_logp_grad_padded(bpo, x, ypo, m, const)
    lsp = torch.full((C, 1), -1.5, device=beta.device)
    args = (bpo, vp, gp, lsp, r["bgs"], r["lts"], x, ypo, m)
    out = pacc.fused_mala_poisson_step(*args, noise=noise, const=const)
    ref = pacc.fused_mala_poisson_step_plain(
        *args[:3], lsp.expand(C, G), *args[4:], noise, const=const)
    torch.cuda.synchronize()
    _check_step(out, ref, bpo, r["logu"], 3)
    assert {k: n for k, n in LAUNCHES.items() if n} == {
        "mala_step": 2, "pois_mala_step": 1}


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_tiled_obs_passes_match_plain(dev, p, case):
    _tiled_obs_passes(_tile_inputs(dev, *case, p))


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_tiled_mala_steps_match_plain(dev, p, case):
    _tiled_mala_steps(_tile_inputs(dev, *case, p))


@pytest.mark.parametrize("p", [3, 8])
def test_tiled_kernels_at_the_smallest_tile(dev, p):
    """n = 3000 observations a unit: one unit a tile (the plan's least),
    over the 48 KB default. All but every 100th row is masked, so the
    float32 sums over the unit's rows stay within the tolerance."""
    from nestmc_torch.ops.cuda.common import TILE_KINDS, tile_plan

    assert all(tile_plan(k, 3000, p)[0] == 1 for k in TILE_KINDS)
    r = _tile_inputs(dev, 33, 3, 3000, p, sparse=True)
    _tiled_obs_passes(r)
    _tiled_mala_steps(r)


class _FixedKey:
    def __init__(self, k0, k1):
        self.key = (k0, k1)

    def philox_key(self):
        return self.key


def test_tiled_mala_philox_is_deterministic(dev):
    """Two Philox launches with one key give bitwise-equal outputs, with
    and without the fold; another key gives other proposals."""
    r = _tile_inputs(dev, 130, 70, 13, 3)
    x, m, y, ypo, const = r["x"], r["mask"], r["y"], r["ypo"], r["const"]
    beta, bpo = r["beta"], r["bpo"]
    C = beta.shape[0]
    v, g = loglik.logistic_logp_grad_padded(beta, x, y, m)
    vp, gp = loglik.poisson_logp_grad_padded(bpo, x, ypo, m, const)
    ls = torch.full((C, 1), -1.3, device=dev)

    def run(k0, k1, rf=None):
        return (fused_mala_logistic_step(beta, v, g, ls, r["mu"], r["lt"], x,
                                         y, m, rng=_FixedKey(k0, k1),
                                         rhat_fold=rf)
                + pacc.fused_mala_poisson_step(
                    bpo, vp, gp, ls, r["bgs"], r["lts"], x, ypo, m,
                    rng=_FixedKey(k0, k1), const=const))

    for rf in (None, r["fold"]):
        a, b = run(7, 11, rf), run(7, 11, rf)
        torch.cuda.synchronize()
        assert all(torch.equal(s, t) for s, t in zip(a, b))
    c = run(8, 11)
    assert not torch.equal(a[0], c[0])
    assert all(bool(torch.isfinite(t).all()) for t in a + c)


@pytest.mark.parametrize("p", [3, 4])
def test_tile_plan_mirrors_the_launchers(dev, p):
    """common.tile_plan gives the units a tile and the shared memory that
    the kernels' launchers compute (csrc/tile_plan.cu)."""
    import ctypes

    from nestmc_torch.ops.cuda import _build
    from nestmc_torch.ops.cuda.common import TILE_KINDS, tile_plan

    lib = _build.library(p)
    for i, kind in enumerate(TILE_KINDS):
        for n in (1, 10, 13, 20, 32, 50, 500, 3000, 12288 // (p + 2)):
            tg = ctypes.c_int()
            smem = lib.nestmc_tile_plan(i, n, ctypes.byref(tg))
            assert (tg.value, smem) == (tile_plan(kind, n, p)[0],
                                        tile_plan(kind, n, p)[2]), (kind, n)


# ---- newton_step_kernel and segment_kernel on the tile: the Logit and
# Poisson Newton steps in every mode, and the ragged segment passes, at
# partial tiles and odd sizes.
def _tiled_newton_steps(r):
    """The Logit Newton step refresh and frozen, without and with the
    fold, and the Poisson one refresh and frozen, external noise: kernel
    vs plain; frozen passes h itself through."""
    x, m, y, ypo, const = r["x"], r["mask"], r["y"], r["ypo"], r["const"]
    beta, bpo = r["beta"], r["bpo"]
    C, G, _ = beta.shape
    noise = (r["eps"], r["logu"])
    v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, m)
    ls = torch.full((C, 1), -0.3, device=beta.device)
    reset_launch_counts()
    for frozen in (False, True):
        for rf in (None, r["fold"]):
            args = (beta, v, g, h, ls.expand(C, G), r["mu"], r["lt"], x, y, m)
            out = fused_newton_logistic_step(*args, noise=noise,
                                             frozen=frozen, rhat_fold=rf)
            ref = fused_newton_logistic_step_plain(*args, noise,
                                                   frozen=frozen,
                                                   rhat_fold=rf)
            torch.cuda.synchronize()
            if frozen:
                assert out[3] is h
                out, ref = out[:3] + out[4:], ref[:3] + ref[4:]
            _check_step(out, ref, beta, r["logu"], 3 if frozen else 4)
    vp, gp, hp = loglik.poisson_logp_grad_hess_padded(bpo, x, ypo, m, const)
    lsp = torch.full((C, G), -0.3, device=beta.device)
    for frozen in (False, True):
        args = (bpo, vp, gp, hp, lsp, r["bgs"], r["lts"], x, ypo, m)
        out = pacc.fused_newton_poisson_step(*args, noise=noise,
                                             frozen=frozen, const=const)
        ref = pacc.fused_newton_poisson_step_plain(*args, noise,
                                                   frozen=frozen, const=const)
        torch.cuda.synchronize()
        if frozen:
            assert out[3] is hp
            out, ref = out[:3] + out[4:], ref[:3] + ref[4:]
        _check_step(out, ref, bpo, r["logu"], 3 if frozen else 4)
    assert {k: n for k, n in LAUNCHES.items() if n} == {
        "newton_step_refresh": 2, "newton_step_frozen": 2,
        "pois_newton_step_refresh": 1, "pois_newton_step_frozen": 1}


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_tiled_newton_steps_match_plain(dev, p, case):
    _tiled_newton_steps(_tile_inputs(dev, *case, p))


@pytest.mark.parametrize("p", [3, 8])
def test_tiled_newton_steps_at_the_smallest_tile(dev, p):
    """n = 3000 observations a unit: one unit a Newton tile, over the
    48 KB the one-unit stage allowed (sparse rows, as above)."""
    from nestmc_torch.ops.cuda.common import tile_plan

    assert all(tile_plan(k, 3000, p)[0] == 1 for k in (
        "newton", "newton_noise", "pois_newton", "pois_newton_noise"))
    _tiled_newton_steps(_tile_inputs(dev, 33, 3, 3000, p, sparse=True))


def test_tiled_newton_philox_is_deterministic(dev):
    """Two Philox launches with one key give bitwise-equal outputs in
    every mode; another key gives other proposals."""
    r = _tile_inputs(dev, 130, 70, 13, 3)
    x, m, y, ypo, const = r["x"], r["mask"], r["y"], r["ypo"], r["const"]
    beta, bpo = r["beta"], r["bpo"]
    C, G, _ = beta.shape
    v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, m)
    vp, gp, hp = loglik.poisson_logp_grad_hess_padded(bpo, x, ypo, m, const)
    ls = torch.zeros(C, G, device=dev)

    def run(k0, k1, frozen, rf=None):
        return (fused_newton_logistic_step(
                    beta, v, g, h, ls, r["mu"], r["lt"], x, y, m,
                    rng=_FixedKey(k0, k1), frozen=frozen, rhat_fold=rf)
                + pacc.fused_newton_poisson_step(
                    bpo, vp, gp, hp, ls, r["bgs"], r["lts"], x, ypo, m,
                    rng=_FixedKey(k0, k1), frozen=frozen, const=const))

    for frozen, rf in ((False, None), (True, None), (True, r["fold"])):
        a, b = run(7, 11, frozen, rf), run(7, 11, frozen, rf)
        torch.cuda.synchronize()
        assert all(torch.equal(s, t) for s, t in zip(a, b))
        c = run(8, 11, frozen, rf)
        assert not torch.equal(a[0], c[0])
        assert all(bool(torch.isfinite(t).all()) for t in a + c)


# ---- rwmh_step_kernel and loglik_kernel on the tile: the Logit and
# Poisson value-only passes and RW-MH steps at partial tiles and odd sizes.
def _tiled_rw_steps(r):
    """The Logit and Poisson value-only loglik and RW-MH step, external
    noise: kernel vs plain."""
    x, m, y, ypo, const = r["x"], r["mask"], r["y"], r["ypo"], r["const"]
    beta, bpo = r["beta"], r["bpo"]
    C, G, _ = beta.shape
    noise = (r["eps"], r["logu"])
    reset_launch_counts()
    for kern, plain, a in (
        (logistic_loglik, loglik.logistic_loglik_padded, (beta, x, y, m)),
        (pois.poisson_loglik, loglik.poisson_loglik_padded,
         (bpo, x, ypo, m, const)),
    ):
        out, ref = kern(*a), plain(*a)
        torch.cuda.synchronize()
        _assert_close(out, ref, kern.__name__)
    lik = loglik.logistic_loglik_padded(beta, x, y, m)
    ls = torch.full((C, 1), -1.6, device=beta.device)
    args = (beta, lik, ls, r["mu"], r["lt"], x, y, m)
    out = fused_rwmh_logistic_step(*args, noise=noise)
    ref = fused_rwmh_logistic_step_plain(*args[:2], ls.expand(C, G),
                                         *args[3:], noise)
    torch.cuda.synchronize()
    _check_step(out, ref, beta, r["logu"], 2)
    likp = loglik.poisson_loglik_padded(bpo, x, ypo, m, const)
    lsp = torch.full((C, G), -1.8, device=beta.device)
    args = (bpo, likp, lsp, r["bgs"], r["lts"], x, ypo, m)
    out = pacc.fused_rwmh_poisson_step(*args, noise=noise, const=const)
    ref = pacc.fused_rwmh_poisson_step_plain(*args, noise, const=const)
    torch.cuda.synchronize()
    _check_step(out, ref, bpo, r["logu"], 2)
    assert {k: n for k, n in LAUNCHES.items() if n} == {
        "loglik": 1, "pois_loglik": 1, "rwmh_step": 1, "pois_rwmh_step": 1}


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_tiled_rw_steps_match_plain(dev, p, case):
    _tiled_rw_steps(_tile_inputs(dev, *case, p))


@pytest.mark.parametrize("p", [3, 8])
def test_tiled_rw_steps_at_the_smallest_tile(dev, p):
    """n = 3000 observations a unit: one unit a tile, over the 48 KB the
    one-unit RW step and loglik took (sparse rows, as above)."""
    from nestmc_torch.ops.cuda.common import tile_plan

    assert all(tile_plan(k, 3000, p)[0] == 1 for k in (
        "rwmh", "rwmh_noise", "pois_rwmh", "pois_rwmh_noise", "loglik"))
    _tiled_rw_steps(_tile_inputs(dev, 33, 3, 3000, p, sparse=True))


def test_tiled_rw_philox_is_deterministic(dev):
    """Two Philox launches of the RW steps with one key give bitwise-equal
    outputs; another key gives other proposals."""
    r = _tile_inputs(dev, 130, 70, 13, 3)
    x, m, y, ypo, const = r["x"], r["mask"], r["y"], r["ypo"], r["const"]
    beta, bpo = r["beta"], r["bpo"]
    C = beta.shape[0]
    lik = loglik.logistic_loglik_padded(beta, x, y, m)
    likp = loglik.poisson_loglik_padded(bpo, x, ypo, m, const)
    ls = torch.full((C, 1), -1.6, device=dev)

    def run(k0, k1):
        return (fused_rwmh_logistic_step(beta, lik, ls, r["mu"], r["lt"], x,
                                         y, m, rng=_FixedKey(k0, k1))
                + pacc.fused_rwmh_poisson_step(
                    bpo, likp, ls, r["bgs"], r["lts"], x, ypo, m,
                    rng=_FixedKey(k0, k1), const=const))

    a, b = run(7, 11), run(7, 11)
    torch.cuda.synchronize()
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    c = run(8, 11)
    assert not torch.equal(a[0], c[0])
    assert all(bool(torch.isfinite(t).all()) for t in a + c)


@pytest.mark.parametrize("case", [
    # (C, G, p, sizes)
    # one group of 1500 observations, longer than a chunk (32 groups x 32
    # observations at p=3), so its sums carry across chunks, and a tile
    # whose observations exceed the chunk budget
    (33, 40, 3, [1500] + [30] * 39),
    # groups of 40 at p=4 (32 groups a tile, chunks of 1024 observations):
    # every full tile spans two chunks and one group straddles the chunk
    # boundary; C below one chain tile
    (20, 33, 4, [40] * 33),
    # config 4's 5..30 observations, G not a multiple of the tile, empty
    # groups among them, C not a multiple of 32
    (70, 100, 3, [0 if i % 17 == 3 else 5 + (7 * i) % 26
                  for i in range(100)]),
    # fewer groups than a tile; a single chain
    (1, 5, 3, [3, 0, 31, 1, 2]),
    (40, 9, 8, [0, 300, 1, 0, 64, 65, 7, 0, 2]),
])
def test_segment_tile_edges_match_plain(dev, case):
    """The tiled segment passes at the tile's ragged edges: kernel vs plain
    within the segment contract (loglik 2e-5 + 2e-5|b|, gradient 2e-5 +
    2e-4|b|), empty groups exactly 0."""
    C, G, p, sizes = case
    beta, x, y, layout = _ragged_inputs(dev, C, G, p, sizes)
    reset_launch_counts()
    v = logistic_loglik_segment(beta, x, y, layout)
    vg, g = logistic_logp_grad_segment(beta, x, y, layout)
    rv = logistic_loglik_segment_plain(beta, x, y, layout)
    rvg, rg = logistic_logp_grad_segment_plain(beta, x, y, layout)
    torch.cuda.synchronize()
    assert LAUNCHES["seg_loglik"] == LAUNCHES["seg_logp_grad"] == 1
    for a, b, rtol in ((v, rv, 2e-5), (vg, rvg, 2e-5), (g, rg, 2e-4)):
        assert bool(((a - b).abs() <= 2e-5 + rtol * b.abs()).all()), \
            float((a - b).abs().max())
    empty = torch.as_tensor(sizes, device=dev) == 0
    assert bool((v[:, empty] == 0).all() and (g[:, empty] == 0).all())


# ---- the command line's path: per-unit logliks, checkpoints, cli.main ----

@pytest.mark.parametrize("impl,kernel", [
    ("padded", "loglik"), ("bucket", "loglik"),
    ("pallas-segment", "seg_loglik"),
])
def test_group_loglik_launches_its_kernel(dev, impl, kernel):
    """hier_logistic's group_loglik on CUDA tensors launches the route's
    value-only pass (loglik, once per size bucket on the bucket route;
    seg_loglik) and nothing else, and matches the CPU model's plain
    version (1e-4 + 1e-4 |b|)."""
    from nestmc_torch.models.hier_logistic import _resolve_loglik

    ragged = impl != "padded"
    kw = {"loglik_impl": impl} if ragged else {}
    models = {}
    for dv in (dev, torch.device("cpu")):
        data, _ = synth_logistic(3, G=70, n=24, p=3, ragged=ragged,
                                 min_obs=1, device=dv)
        models[dv.type] = (make_hier_logistic(data, **kw), data)
    layout = _resolve_loglik(models["cuda"][1],
                             impl if ragged else "auto")[4]
    want = len(layout().buckets) if impl == "bucket" else 1
    g = torch.Generator().manual_seed(4)
    beta = 0.5 * torch.randn(130, 70, 3, generator=g)
    pos = {"beta": beta, "mu": torch.zeros(130, 3),
           "log_tau": torch.zeros(130, 3)}
    reset_launch_counts()
    out = models["cuda"][0].derived["group_loglik"](
        {k: v.to(dev) for k, v in pos.items()})
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {kernel: want}
    ref = models["cpu"][0].derived["group_loglik"](pos)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


def test_poisson_unit_logliks_launch_pois_loglik(dev):
    """nested_poisson's subject_loglik and group_loglik each launch
    pois_loglik once and match the CPU model (1e-4 + 1e-4 |b|)."""
    out = {}
    for dv in (dev, torch.device("cpu")):
        data, _ = synth_poisson3(3, G=9, subjects_per_group=4, n=10, p=3,
                                 device=dv)
        model = make_nested_poisson(data)
        g = torch.Generator().manual_seed(5)
        pos = {"beta_s": 0.3 * torch.randn(130, 36, 3, generator=g).to(dv)}
        reset_launch_counts()
        out[dv.type] = {k: model.derived[k](pos) for k in
                        ("subject_loglik", "group_loglik")}
        if dv.type == "cuda":
            assert {k: v for k, v in LAUNCHES.items() if v} == {
                "pois_loglik": 2}
    for k in ("subject_loglik", "group_loglik"):
        torch.testing.assert_close(out["cuda"][k].cpu(), out["cpu"][k],
                                   rtol=1e-4, atol=1e-4)


def test_checkpoint_resume_on_the_card(dev, tmp_path):
    """A sample-phase checkpoint on the card round-trips the KernelState
    (Newton cache, frozen Hessian), the CUDA and host generator states and
    the streamed accumulators: the resumed run's draws and all-parameter
    R-hat are the uninterrupted run's."""
    from nestmc_torch.checkpoint import latest_tag, load_checkpoint
    from nestmc_torch.engine import sample
    from nestmc_torch.kernels.state import checkpoint_template
    from nestmc_torch.rng import SweepRNG

    data, _ = synth_logistic(3, G=40, n=12, p=3, device=dev)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=40, warmup=30, draws=41, seed=2,
                      segment_size=20, full_rhat=True,
                      checkpoint_dir=str(tmp_path), checkpoint_every=1,
                      collect={"mu": None, "beta": None},
                      log_every_segment=False))
    full = sample(model, data, cfg)
    assert latest_tag(str(tmp_path)) == "sample_000000041"
    template = checkpoint_template(model, cfg, data, with_acc=True)
    carry, meta = load_checkpoint(str(tmp_path), "sample_000000020",
                                  template)
    state = carry["state"]
    assert state.cache["beta"]["h"].device.type == "cuda"
    assert carry["rng"]["device"].dtype == torch.uint8
    rng = SweepRNG(2, dev)
    rng.set_state(carry["rng"])
    res = sample(model, data, cfg, rng=rng, init_state=state,
                 skip_warmup=True, init_acc=carry["acc"], draws_offset=20)
    for k in ("mu", "beta"):
        assert torch.equal(res.draws[k], full.draws[k][:, 20:]), k
    for k, v in full.full_rhat.items():
        assert torch.equal(res.full_rhat[k], v), k


def test_cli_run_on_the_card(dev, tmp_path, capsys):
    """python -m nestmc_torch run on the card (its default) at a small
    scale: the metric line names the card, and group_loglik collection
    launches one loglik a retained draw."""
    import json

    from nestmc_torch import cli

    path = str(tmp_path / "a.npz")
    reset_launch_counts()
    rc = cli.main(["run", "--preset", "hier-logistic-100", "--scale",
                   "0.05", "--chains", "16", "--collect", "mu,group_loglik",
                   "--metric-json", "--quiet", "--save-draws", path])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["backend"] == torch.cuda.get_device_name(dev)
    assert res["n_devices"] == 1
    assert res["unit"] == "ESS/s/GPU"
    draws = res["config"]["run"]["draws"]
    assert LAUNCHES["loglik"] == draws
    assert LAUNCHES["newton_step_frozen"] == draws
    assert cli.main(["compare", path, path, "--method", "waic"]) == 0


# ---- the hierarchical GLM, predictive checks and the CSV loader ----

def _binomial_inputs(dev, C=130, G=9, n=14, p=4, seed=7):
    """The binomial family's operands of the logistic kernels: the mask a
    trials weight in 0..10 (zero-weight rows in the middle of a group), y
    the fraction of successes."""
    g = torch.Generator().manual_seed(seed)
    beta, x, _, _, mu, lt, eps, logu = _inputs(dev, C, G, n, p, seed)
    m = torch.randint(0, 11, (G, n), generator=g).float()
    m[1, n // 2 - 1:n // 2 + 2] = 0.0
    k = torch.floor(torch.rand(G, n, generator=g) * (m + 1.0))
    y = torch.where(m > 0, k / m.clamp_min(1.0), torch.zeros_like(m))
    return beta, x, y.to(dev), m.to(dev), mu, lt, eps, logu


def test_logistic_kernels_on_a_binomial_weighted_mask(dev):
    """The logistic obs passes and the three fused steps with an integer
    weight mask and fractional y, as the binomial family feeds them."""
    beta, x, y, w, mu, lt, eps, logu = _binomial_inputs(dev)
    C, G, p = beta.shape
    assert float(w.max()) > 1.0 and bool((w == 0).any())
    assert bool(((y > 0) & (y < 1)).any())
    for kern, plain in (
        (lambda *a: (logistic_loglik(*a),),
         lambda *a: (loglik.logistic_loglik_padded(*a),)),
        (logistic_logp_grad, loglik.logistic_logp_grad_padded),
        (logistic_logp_grad_hess, loglik.logistic_logp_grad_hess_padded),
    ):
        out, ref = kern(beta, x, y, w), plain(beta, x, y, w)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            _assert_close(a, b, "obs pass")
    v, gr, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, w)
    for frozen in (False, True):
        args = (beta, v, gr, h, torch.zeros(C, G, device=dev), mu, lt, x,
                y, w)
        out = fused_newton_logistic_step(*args, noise=(eps, logu),
                                         frozen=frozen)
        ref = fused_newton_logistic_step_plain(*args, (eps, logu),
                                               frozen=frozen)
        torch.cuda.synchronize()
        keep = [0, 1, 2, 4] if frozen else [0, 1, 2, 3, 4]
        _check_step([out[i] for i in keep], [ref[i] for i in keep], beta,
                    logu, len(keep) - 1)
    ls = torch.full((C, G), -1.6, device=dev)
    args = (beta, v, gr, ls, mu, lt, x, y, w)
    _check_step(fused_mala_logistic_step(*args, noise=(eps, logu)),
                fused_mala_logistic_step_plain(*args, (eps, logu)),
                beta, logu, 3)
    args = (beta, v, ls, mu, lt, x, y, w)
    _check_step(fused_rwmh_logistic_step(*args, noise=(eps, logu)),
                fused_rwmh_logistic_step_plain(*args, (eps, logu)),
                beta, logu, 2)


def test_poisson_steps_with_a_broadcast_prior_mean(dev):
    """The Poisson steps as hier_glm's poisson family calls them: bg_s the
    shared mu broadcast to every group (made contiguous), const once."""
    C, G, n, p = 130, 11, 10, 3
    g = torch.Generator().manual_seed(9)
    x = 0.5 * torch.randn(G, n, p, generator=g)
    x[:, :, 0] = 1.0
    mask = torch.ones(G, n)
    mask[2, 3:6] = 0.0
    y = torch.poisson(torch.full((G, n), 1.5), generator=g) * mask
    beta = 0.3 * torch.randn(C, G, p, generator=g)
    mu = 0.2 * torch.randn(C, p, generator=g)
    lt = -1.0 + 0.2 * torch.randn(C, p, generator=g)
    eps = torch.randn(C, G, p, generator=g)
    logu = torch.log(torch.rand(C, G, generator=g))
    beta, x, y, mask, mu, lt, eps, logu = (
        t.to(dev) for t in (beta, x, y, mask, mu, lt, eps, logu))
    bg = mu[:, None, :].expand(C, G, p).contiguous()
    const = loglik.poisson_const(y, mask)
    v, gr, h = loglik.poisson_logp_grad_hess_padded(beta, x, y, mask, const)
    ls = torch.full((C, G), -1.2, device=dev)
    for step, plain, args, kw, ai in (
        (pacc.fused_rwmh_poisson_step, pacc.fused_rwmh_poisson_step_plain,
         (beta, v, ls, bg, lt, x, y, mask), {}, 2),
        (pacc.fused_mala_poisson_step, pacc.fused_mala_poisson_step_plain,
         (beta, v, gr, ls, bg, lt, x, y, mask), {}, 3),
        (pacc.fused_newton_poisson_step, pacc.fused_newton_poisson_step_plain,
         (beta, v, gr, h, torch.zeros_like(ls), bg, lt, x, y, mask),
         {"frozen": False}, 4),
    ):
        out = step(*args, noise=(eps, logu), const=const, **kw)
        ref = plain(*args, (eps, logu), const=const, **kw)
        torch.cuda.synchronize()
        _check_step(out, ref, beta, logu, ai)


@pytest.mark.parametrize("family,expect", [
    ("poisson", {"pois_newton_step_refresh": 6, "pois_newton_step_frozen": 8,
                 "pois_logp_grad_hess": 7, "pois_logp_grad": 8,
                 "pois_loglik": 8}),
    ("binomial", {"newton_step_refresh": 6, "newton_step_frozen": 8,
                  "logp_grad_hess": 7, "logp_grad": 8, "loglik": 8}),
])
def test_glm_kernel_families_launch_their_kernels(dev, family, expect):
    """A short Newton run of hier_glm's kernel families on the card: the
    launches the schedule implies (the binomial transform adds none), and
    the streamed R-hat folded in the binomial step."""
    from nestmc_torch import sample
    from nestmc_torch.models import make_hier_glm, synth_glm

    data, _ = synth_glm(3, family=family, G=20, n=12, p=3, device=dev)
    model = make_hier_glm(data, family=family, tau_prior="invgamma")
    reset_launch_counts()
    post = sample(model, data, SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=64, warmup=6, draws=8, full_rhat=True,
                      collect={"mu": None, "group_loglik": None},
                      log_every_segment=False)))
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == expect
    assert post.draws["group_loglik"].shape == (64, 8, 20)
    assert bool(torch.isfinite(post.draws["group_loglik"]).all())


def test_load_csv_on_the_card(dev, tmp_path):
    from nestmc_torch.io import load_csv

    f = tmp_path / "d.csv"
    f.write_text("5,1,0.5,1.0\n5,0,0.25,2.0\n9,1,1.0,-1.0\n")
    a = load_csv(str(f), native=True, device=dev)
    b = load_csv(str(f), native=False, device="cpu")
    assert a.y.device.type == "cuda" and a.offsets.device.type == "cuda"
    for k in ("y", "x", "segment_ids", "offsets"):
        assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k


def test_posterior_predictive_on_the_card(dev):
    from nestmc_torch import posterior_predictive, predictive_pvalue, sample
    from nestmc_torch.models import make_hier_glm, synth_glm

    data, _ = synth_glm(4, family="binomial", G=16, n=10, p=3, trials=6,
                        device=dev)
    model = make_hier_glm(data, family="binomial", tau_prior="invgamma")
    post = sample(model, data, SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=32, warmup=100, draws=100,
                      log_every_segment=False)))
    y_rep = posterior_predictive(model, post, data, SweepRNG(1, dev), num=16)
    assert y_rep.device.type == "cuda" and y_rep.shape == (16, 16, 10)
    assert bool(((y_rep >= 0) & (y_rep <= 6)).all())
    assert bool((y_rep == torch.round(y_rep)).all())
    assert 0.0 <= float(predictive_pvalue(y_rep, data)) <= 1.0


def _ragged_lists(G=37, p=3, seed=0):
    import numpy as np

    r = np.random.default_rng(seed)
    sizes = r.integers(1, 41, size=G)
    sizes[5] = 0
    xs = [r.normal(size=(s, p)).astype(np.float32) for s in sizes]
    ys = [(r.random(s) < 0.4).astype(np.float32) for s in sizes]
    return ys, xs


def test_ragged_convert_padded_vs_segment(dev):
    """Data built from per-group lists on the card: the padded form's
    loglik kernel and the ragged form's seg_loglik kernel agree within the
    segment contract |a-b| <= 2e-5 + 2e-5 |b|; to_ragged gives
    RaggedData.from_ragged's arrays exactly."""
    from nestmc_torch.data import NestedData, RaggedData

    ys, xs = _ragged_lists()
    nd = NestedData.from_ragged(ys, xs, device=dev)
    rd = nd.to_ragged()
    rd2 = RaggedData.from_ragged(ys, xs, device=dev)
    for k in ("y", "x", "segment_ids", "offsets"):
        assert torch.equal(getattr(rd, k), getattr(rd2, k)), k
    beta = torch.randn(70, nd.num_groups, 3, device=dev,
                       generator=torch.Generator(dev).manual_seed(1))
    reset_launch_counts()
    a = logistic_loglik(beta, nd.x, nd.y, nd.mask)
    b = logistic_loglik_segment(beta, rd.x, rd.y, SegmentLayout.build(
        rd.segment_ids, rd.num_groups))
    torch.cuda.synchronize()
    assert LAUNCHES["loglik"] == 1 and LAUNCHES["seg_loglik"] == 1
    assert bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all())
    assert float(a[:, 5].abs().max()) == 0.0


def test_ragged_convert_pad_groups_kernels(dev):
    """pad_groups_to on the card: the obs-pass kernels on the padded data
    equal the unpadded ones on the real groups bit for bit (cells are
    independent) and give exactly 0 on the padded groups."""
    from nestmc_torch.data import NestedData

    ys, xs = _ragged_lists(G=29, p=4, seed=2)
    nd = NestedData.from_ragged(ys, xs, device=dev)
    pd = nd.pad_groups_to(64)
    beta = torch.randn(33, 64, 4, device=dev,
                       generator=torch.Generator(dev).manual_seed(3))
    for fn in (logistic_loglik, logistic_logp_grad, logistic_logp_grad_hess):
        full = fn(beta, pd.x, pd.y, pd.mask)
        part = fn(beta[:, :29].contiguous(), nd.x, nd.y, nd.mask)
        full = full if isinstance(full, tuple) else (full,)
        part = part if isinstance(part, tuple) else (part,)
        for f, q in zip(full, part):
            assert torch.equal(f[:, :29], q), fn.__name__
            assert float(f[:, 29:].abs().max()) == 0.0, fn.__name__


def test_user_model_on_the_card(dev):
    """A model written for one chain, lifted by vmap_chains, on CUDA
    tensors: MALA through torch.autograd under vmap runs, launches no
    kernel of the port, and its draws are finite."""
    from nestmc_torch import sample
    from nestmc_torch.distributions import logpdf_normal
    from nestmc_torch.model import Block, ModelSpec, vmap_chains

    y = torch.tensor([0.4, 1.2, -0.3, 0.8, 1.5], device=dev)

    def cond(name, value, state, data):
        return (torch.sum(logpdf_normal(data["y"], value, 1.0))
                + logpdf_normal(value, 0.0, 2.0))

    model = vmap_chains(ModelSpec(
        name="tiny", blocks=(Block("theta", ()),), cond_logdensity=cond,
        init_state=lambda rng, data, chains: {"theta": rng.normal(())}))
    reset_launch_counts()
    post = sample(model, {"y": y}, SamplerConfig(
        kernel=KernelConfig(algorithm="mala"),
        run=RunConfig(chains=32, warmup=200, draws=400,
                      log_every_segment=False)))
    assert not any(LAUNCHES.values())
    assert post.draws["theta"].device.type == "cuda"
    assert abs(float(post.mean("theta")) - 3.6 / 5.25) < 0.1


@pytest.mark.parametrize("algorithm,impl", [
    ("newton", "auto"), ("mala", "auto"), ("newton", "pallas-segment")])
def test_same_seed_bitwise_on_the_card(dev, algorithm, impl):
    """Two runs at one seed give the same bits on the card (no atomics on
    the path: the segment route's plain Hessian pass reduces by a
    segmented sum, not a scatter-add); another seed moves mu."""
    from nestmc_torch import sample

    def run(seed):
        data, _ = synth_logistic(21, G=40, n=12, p=3, device=dev,
                                 ragged=impl != "auto", min_obs=1)
        return sample(make_hier_logistic(data, tau_prior="invgamma",
                                         loglik_impl=impl), data,
                      SamplerConfig(
                          kernel=KernelConfig(algorithm=algorithm),
                          run=RunConfig(chains=64, warmup=40, draws=40,
                                        seed=seed, log_every_segment=False)))

    a, b, c = run(9), run(9), run(10)
    for k in a.draws:
        assert torch.equal(a.draws[k], b.draws[k]), k
    assert not torch.equal(a.draws["mu"], c.draws["mu"])


@pytest.mark.parametrize("name", STEPS)
def test_step_kernels_at_offsets_slice_the_full_launch(dev, name):
    """Each step kernel in Philox mode, launched on a chain slice and on
    a unit slice with its offsets (c0, g0, G_total), gives that slice of
    the full-width launch bitwise (a sharded run's draws are the
    unsharded run's); a partial tile at both ends of each slice."""
    C, U = 70, 37
    a = step_inputs(C, U, 9, 3, name, dev)
    full = run_step(name, a, SweepRNG(5, dev))
    for cs, us in ((slice(33, 70), slice(None)), (slice(None), slice(17, 37)),
                   (slice(0, 33), slice(None))):
        part = run_step(name, cut_inputs(a, cs, us), SweepRNG(5, dev), cs,
                        us, C, U)
        for f, q in zip(full, part):
            assert torch.equal(q, f[cs, us]), name


@pytest.mark.parametrize("C", [64, 70])
def test_plain_matmuls_on_a_chain_slice_are_bitwise(dev, C):
    """ops/loglik.py's batched matmuls on the card (eta_padded, xt_sum,
    xxt_packed): a chain slice's call is the full call's slice bitwise, so
    a chain shard of a plain path repeats the unsharded run's bits."""
    from nestmc_torch.ops.loglik import eta_padded, xt_sum, xxt_packed

    g = torch.Generator().manual_seed(3)
    x = (0.5 * torch.randn(37, 9, 4, generator=g)).to(dev)
    beta = (0.3 * torch.randn(C, 37, 4, generator=g)).to(dev)
    r = torch.randn(C, 37, 9, generator=g).to(dev)
    for cs in (slice(33, C), slice(0, 3)):
        assert torch.equal(eta_padded(beta, x)[cs], eta_padded(beta[cs], x))
        assert torch.equal(xt_sum(r, x)[cs], xt_sum(r[cs], x))
        assert torch.equal(xxt_packed(x, r.abs())[cs],
                           xxt_packed(x, r[cs].abs()))


def _graph_eager_pair(dev, make, algorithm, thin=1, rthin=1,
                     precond="none"):
    """(graph run, eager run, their launch counts, their RNGs) of one
    model from the same seed: sample() on the card replays its captured
    steps unless asked for the eager loop."""
    from nestmc_torch import sample

    out = []
    for eager in (False, True):
        model, data = make()
        rng = SweepRNG(7, dev)
        reset_launch_counts()
        post = sample(model, data, SamplerConfig(
            kernel=KernelConfig(algorithm=algorithm, precond=precond),
            run=RunConfig(chains=64, warmup=60, draws=14, thin=thin,
                          full_rhat=True, full_rhat_thin=rthin,
                          segment_size=6, log_every_segment=False)),
            rng=rng, _eager=eager)
        out.append((post, dict(LAUNCHES), rng))
    return out


@pytest.mark.parametrize("algorithm,impl,thin,rthin,precond", [
    ("newton", "auto", 1, 1, "none"), ("mala", "auto", 1, 1, "none"),
    ("rwmh", "auto", 1, 1, "none"), ("newton", "auto", 2, 1, "none"),
    ("mala", "auto", 1, 2, "none"), ("newton", "bucket", 1, 1, "none"),
    ("mala", "pallas-segment", 1, 1, "none"),
    ("rwmh", "auto", 1, 1, "full"), ("mala", "auto", 1, 1, "diag")])
def test_graph_replay_is_the_eager_loop_bitwise(dev, algorithm, impl, thin,
                                                 rthin, precond):
    """The captured warmup sweep and sampling draw, replayed, give the
    eager loop's draws, streamed R-hat, final carry, launch counts and
    generator states bit for bit (with a preconditioner: the unfused
    updates, the full one's Cholesky factor without a host check; 60
    warmup sweeps, so it is in use after the 50 its EMA waits)."""
    def make():
        data, _ = synth_logistic(21, G=40, n=12, p=3, device=dev,
                                 ragged=impl != "auto", min_obs=1)
        return make_hier_logistic(data, tau_prior="invgamma",
                                  loglik_impl=impl), data

    (g, g_launch, g_rng), (e, e_launch, e_rng) = _graph_eager_pair(
        dev, make, algorithm, thin, rthin, precond)
    assert g.timings["sweep"] == "graph" and e.timings["sweep"] == "eager"
    assert g_launch == e_launch
    for k in e.draws:
        assert torch.equal(g.draws[k], e.draws[k]), k
    for k in e.full_rhat:
        assert torch.equal(g.full_rhat[k], e.full_rhat[k]), k
    for k, v in e.final_state.position.items():
        assert torch.equal(g.final_state.position[k], v), k
    for k, v in e.accept_rates.items():
        assert torch.equal(g.accept_rates[k], v), k
    for a, b in zip(g_rng.get_state().values(), e_rng.get_state().values()):
        assert torch.equal(a, b)


def test_graph_replay_collects_a_selection_by_index(dev):
    """A collected selection by indices (RunConfig.collect {'beta': [..]})
    is made on the card before the steps, so the captured draw copies
    nothing from the host: graph and eager draws bitwise."""
    from nestmc_torch import sample

    data, _ = synth_logistic(21, G=40, n=12, p=3, device=dev)
    out = []
    for eager in (False, True):
        post = sample(make_hier_logistic(data, tau_prior="invgamma"), data,
                      SamplerConfig(run=RunConfig(
                          chains=64, warmup=10, draws=8, segment_size=4,
                          collect={"beta": [3, 0, 17], "mu": None},
                          log_every_segment=False)),
                      rng=SweepRNG(7, dev), _eager=eager)
        out.append(post)
    assert out[0].timings["sweep"] == "graph"
    assert out[0].draws["beta"].shape == (64, 8, 3, 3)
    for k, v in out[1].draws.items():
        assert torch.equal(out[0].draws[k], v), k


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton"])
def test_graph_replay_of_nested_poisson_is_the_eager_loop(dev, algorithm):
    def make():
        data, _ = synth_poisson3(5, G=8, subjects_per_group=3, n=10, p=2,
                                 device=dev)
        return make_nested_poisson(data, tau_prior="invgamma"), data

    (g, g_launch, g_rng), (e, e_launch, e_rng) = _graph_eager_pair(
        dev, make, algorithm)
    assert g.timings["sweep"] == "graph" and g_launch == e_launch
    for k in e.draws:
        assert torch.equal(g.draws[k], e.draws[k]), k
    for a, b in zip(g_rng.get_state().values(), e_rng.get_state().values()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def graph_ranks(tmp_path_factory):
    """Two gloo ranks spawned on the one card (tests/_torch_dist_worker.py,
    mode 'graph'): their arrays and scalars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from _torch_dist_worker import spawn

    return spawn("graph", tmp_path_factory.mktemp("graph"), timeout=300,
                 device="cuda")


@pytest.mark.parametrize("algorithm", ["newton", "mala", "rwmh"])
def test_chain_sharded_graph_is_the_eager_loop_on_two_ranks(graph_ranks,
                                                           algorithm):
    """Chains split over two gloo ranks on the one card: the step issues
    no collective, so each rank replays its captured steps, and the
    replay gives the eager loop's bits on every rank: the rank's final
    part, the gathered draws, the R-hat maps, both generators, the
    launches and the groups_sum calls (none)."""
    import numpy as np

    for arrays, s in graph_ranks:
        g, e = f"{algorithm}_graph", f"{algorithm}_eager"
        assert s[f"{g}_sweep"] == "graph" and s[f"{e}_sweep"] == "eager"
        assert s[f"{g}_launches"] == s[f"{e}_launches"]
        assert s[f"{g}_groups_sum_calls"] == s[f"{e}_groups_sum_calls"] == 0
        keys = [k for k in arrays if k.startswith(e + ".")]
        assert any(".final." in k for k in keys)
        assert any(".rng." in k for k in keys)
        for k in keys:
            np.testing.assert_array_equal(arrays[g + k[len(e):]], arrays[k],
                                          err_msg=k)


def test_group_sharded_gloo_run_on_the_card_steps_eagerly(graph_ranks):
    """Groups split over gloo ranks sharing a card: the all_reduces go
    through the host, which a graph cannot hold: the eager loop."""
    assert [s["groups_sweep"] for _, s in graph_ranks] == ["eager", "eager"]


# (whole shape, U, block shape, c0, u0): a K=3 block on quads; a K=1 (9,
# 11) fill whose rows straddle quads, its block of chains 1.. and units 6..
# starting at a quad's lane 1; a K=3 fill of an odd unit count (rows 39
# elements apart), its block starting at element 87 (lane 3)
FILL_CASES = [((33, 100, 3), 100, (28, 30, 3), 5, 40),
              ((9, 11), 11, (8, 5), 1, 6),
              ((7, 13, 3), 13, (5, 7, 3), 2, 3)]


@pytest.mark.parametrize("mode", ["words", "uniform", "log_uniform",
                                  "normal"])
def test_philox_fill_matches_plain(dev, mode):
    """The unit-axis noise fill (csrc/philox_fill.cu) against its plain
    version run on the card, whole and on a block, for each of FILL_CASES:
    words and uniforms bitwise, log uniforms and normals within 8 ulps, an
    ulp counted at least 2^-23 (float32 logf, sqrtf, sincospif against
    float64 rounded once; sincospif is good to about 4e-7 absolute near
    its zeros); the block bitwise that block of the whole fill; one launch
    counted a call."""
    from nestmc_torch.ops.cuda.philox_fill import (
        philox_fill,
        philox_fill_plain,
    )

    key = torch.tensor([12345, -678], dtype=torch.int32, device=dev)
    for shape, U, bshape, c0, u0 in FILL_CASES:
        reset_launch_counts()
        out = philox_fill(shape, key, 0, 0, U, mode, dev)
        part = philox_fill(bshape, key, c0, u0, U, mode, dev)
        torch.cuda.synchronize()
        assert LAUNCHES["philox_fill"] == 2
        assert torch.equal(part, out[c0:, u0:u0 + bshape[1]]), shape
        for got, args in ((out, (shape, key, 0, 0, U)),
                          (part, (bshape, key, c0, u0, U))):
            ref = philox_fill_plain(*args, mode, device=dev)
            if mode in ("words", "uniform"):
                assert torch.equal(got, ref), args[0]
            else:
                ulp = (torch.nextafter(ref.abs(), torch.full_like(
                    ref, float("inf"))) - ref.abs()).clamp_min(2.0 ** -23)
                assert bool(((got - ref).abs() <= 8 * ulp).all()), args[0]


def _profiled_draws(dev, spans):
    """(Posterior, the device kernels of the replayed graphs grouped by
    their cudaGraphLaunch's correlation id, in launch order, the card's
    kernels) of a small judged-path run under torch.profiler, with the
    draw step's spans on or off."""
    from torch.profiler import ProfilerActivity, profile

    from nestmc_torch import sample

    data, _ = synth_logistic(21, G=40, n=12, p=3, device=dev)
    cfg = SamplerConfig(run=RunConfig(chains=64, warmup=4, draws=6,
                                      segment_size=3, full_rhat=True,
                                      log_every_segment=False))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        post = sample(make_hier_logistic(data, tau_prior="invgamma"), data,
                      cfg, rng=SweepRNG(7, dev), spans=spans)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if "CUDA" in str(e.device_type())
               and not e.is_user_annotation()
               and not e.name().startswith("nestmc.")]
    launches = [e.correlation_id() for e in sorted(
        (e for e in events if "CUDA" not in str(e.device_type())
         and "GraphLaunch" in e.name()), key=lambda e: e.start_ns())]
    replays = {c: [] for c in launches}
    for e in sorted(on_card, key=lambda e: e.start_ns()):
        if e.correlation_id() in replays:
            replays[e.correlation_id()].append(e)
    return post, replays, on_card


def test_spans_graph_is_the_graph_plus_one_mark_a_boundary(dev):
    """The replayed graphs with spans on hold exactly the kernels of the
    graphs with spans off, plus span_mark kernels: none in a warmup
    replay, and in each draw replay one a boundary of its spans (step,
    sweep, the four blocks and moves with one mark between siblings, the
    sweep's end, then the streamed update, the collection and the copy
    back, and the step's end: 12)."""
    from collections import Counter

    _, off, _ = _profiled_draws(dev, False)
    post, on, _ = _profiled_draws(dev, True)
    assert len(off) == len(on) == 4 + 6
    marks = []
    for a, b in zip(off.values(), on.values()):
        names = [e.name() for e in b if "span_mark" not in e.name()]
        assert Counter(names) == Counter(e.name() for e in a)
        marks.append(sum("span_mark" in e.name() for e in b))
    assert marks == [0] * 4 + [12] * 6
    assert set(post.timings["spans"]) == {
        "step", "sweep", "block.beta", "block.mu", "block.log_tau",
        "move.asis_tau", "step.rhat_update", "step.collect",
        "step.copy_back"}


def test_span_stamps_are_on_the_trace_clock(dev):
    """Spans on, under torch.profiler: each replayed span_mark kernel's
    trace start lies within 3 us of its stamp shifted by one offset fitted
    over the call (the median), and the program's own offset
    (timings['spans_clock'], measured around a synchronised mark) within
    50 us of the fitted one. Prints the residuals and globaltimer's least
    step between stamps (pytest -s)."""
    import numpy as np

    post, replays, on_card = _profiled_draws(dev, True)
    rec = post.spans
    used = max(rec.slots.values())
    stamps = np.concatenate([rows[:, :used].numpy().reshape(-1)
                             for _, rows in rec.segments])
    starts = np.array([e.start_ns() for e in sorted(
        (e for e in on_card if "span_mark" in e.name()
         and e.correlation_id() in replays),
        key=lambda e: e.start_ns())], dtype=np.int64)
    assert len(stamps) == len(starts) == 6 * 12
    assert bool((np.diff(stamps) >= 0).all())
    d = starts - stamps
    fitted = int(np.median(d))
    res = d - fitted
    own = post.timings["spans_clock"]
    assert own == rec.clock
    steps = np.diff(np.unique(stamps))
    print(f"\nspan clock: residuals {res.min()}..{res.max()} ns, "
          f"|res| p50 {np.median(np.abs(res)):.0f} ns; program offset - "
          f"fitted {own['offset_ns'] - fitted} ns (uncertainty "
          f"{own['uncertainty_ns']:.0f}); least stamp step "
          f"{steps.min() if len(steps) else 0} ns")
    assert int(np.abs(res).max()) <= 3000
    assert abs(own["offset_ns"] - fitted) <= 50_000
