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
from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.ops import loglik
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
