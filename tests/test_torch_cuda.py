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
    subject step and its obs-pass kernel on the card in both phases, and
    no logistic kernel."""
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
    }[algorithm]
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
    sweep; the segment route's MALA runs only the segment kernel."""
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
                    else "seg_loglik": 5}
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
