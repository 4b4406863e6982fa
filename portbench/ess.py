"""Rank-normalised split bulk ESS: a frozen copy of the program's estimator
(Vehtari et al. 2021: average ranks pooled over chains and draws, Blom
scores, split chains, FFT autocovariances, Geyer's initial monotone
sequence), computed in float64 a few scalars at a time on the draws'
device."""

from __future__ import annotations

import torch


def _split(x):
    """(C, D, S) -> (2C, D // 2, S), the last draw dropped if D is odd."""
    C, D = x.shape[0], x.shape[1]
    half = D // 2
    return x[:, :2 * half].reshape((2 * C, half) + tuple(x.shape[2:]))


def _rank_normalize(x):
    """Average ranks (ties share their mean rank) pooled over (C * D) per
    scalar, as standard-normal scores with the Blom offset."""
    shape = x.shape
    n = shape[0] * shape[1]
    flat = x.reshape(n, -1)
    s, order = torch.sort(flat, dim=0, stable=True)
    st = s.T.contiguous()
    start = torch.searchsorted(st, st, side="left").T
    end = torch.searchsorted(st, st, side="right").T - 1
    avg = 0.5 * (start + end).to(x.dtype) + 1.0
    ranks = torch.empty_like(avg).scatter_(0, order, avg)
    u = ((ranks - 0.375) / (n + 0.25)).clamp(2.0 ** -24, 1.0 - 2.0 ** -24)
    return torch.special.ndtri(u).reshape(shape)


def _ess(x):
    """Split-chain ESS with Geyer's initial monotone truncation; x (C, D, S)
    -> (S,)."""
    x = _split(x)
    M, N = x.shape[0], x.shape[1]
    xc = x - x.mean(dim=1, keepdim=True)
    size = 1
    while size < 2 * N:
        size *= 2
    f = torch.fft.rfft(xc, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :N] / N
    mean_acov = acov.mean(dim=0)
    w = (acov[:, 0] * N / (N - 1.0)).mean(dim=0)
    b = N * torch.var(x.mean(dim=1), dim=0, correction=1)
    var_plus = (N - 1.0) / N * w + b / N
    var_plus = torch.where(var_plus > 0, var_plus, torch.ones_like(var_plus))
    rho = 1.0 - (w - mean_acov) / var_plus
    K = N // 2
    pairs = rho[:2 * K].reshape((K, 2) + tuple(rho.shape[1:])).sum(dim=1)
    pairs = pairs * (pairs > 0.0).to(pairs.dtype).cumprod(dim=0)
    mono = torch.cummin(pairs, dim=0).values.clamp_min(0.0)
    tau = -1.0 + 2.0 * mono.sum(dim=0)
    mn = torch.tensor(float(M * N), dtype=x.dtype, device=x.device)
    tau = torch.maximum(tau, 1.0 / torch.log10(mn))
    return torch.minimum(M * N / tau, mn)


# scalars a pass: at judged's (1024 chains, ~9,000 draws) a pass's float64
# FFT holds about 1 GB
_AT_ONCE = 4


def ess_bulk(draws: torch.Tensor) -> torch.Tensor:
    """Bulk ESS of every scalar of ``draws`` (C, D, ...) -> (S,) float64,
    the scalars flattened in row-major order."""
    C, D = draws.shape[0], draws.shape[1]
    flat = draws.reshape(C, D, -1)
    out = []
    for s in range(0, flat.shape[2], _AT_ONCE):
        x = flat[:, :, s:s + _AT_ONCE].double()
        out.append(_ess(_rank_normalize(x)))
    return torch.cat(out)
