"""Convergence diagnostics: split R-hat, ESS, MCSE, streaming accumulators.

Port of :mod:`nestmc.diagnostics` (Vehtari, Gelman, Simpson, Carpenter &
Buerkner 2021: rank-normalised + folded R-hat, FFT/Geyer ESS) in float32
on the draws' device. ``draws`` is (chains, draws) or (chains, draws,
*param); reductions broadcast over the trailing parameter dims.

Streaming accumulators keep the reference's layouts: standard
{name: (count (2,), mean (C, 2, ...), m2 (C, 2, ...))} and kernel ("fold")
{name: (count (2,), mean (2, *dims, C), m2 (2, *dims, C))}. The counts and
the fold scalars are host tensors: the engine knows every draw index on the
host, so no device value is read back per draw. A captured segment
(nestmc_torch/segments.py) takes each draw's scalars from a table the host
builds before the segment (:func:`fold_rhat_table`,
:func:`streaming_rhat_table`) and copies to the device once, and keeps the
counts on the host.
"""

from __future__ import annotations

import math

import torch


def _split_chains(x):
    """(C, D, ...) -> (2C, D//2, ...); drops the last draw if D is odd."""
    C, D = x.shape[0], x.shape[1]
    half = D // 2
    x = x[:, : 2 * half]
    return x.reshape((C * 2, half) + tuple(x.shape[2:]))


def _within_between(x):
    """W, B, var_plus over (M, N, ...) split sequences."""
    N = x.shape[1]
    seq_means = x.mean(dim=1)
    w = torch.var(x, dim=1, correction=1).mean(dim=0)
    b = N * torch.var(seq_means, dim=0, correction=1)
    var_plus = (N - 1) / N * w + b / N
    return w, b, var_plus


def split_rhat(draws):
    """Classic split R-hat: sqrt(var_plus / W). draws: (C, D, ...)."""
    x = _split_chains(torch.as_tensor(draws))
    w, _, var_plus = _within_between(x)
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))


def _rank_to_u(ranks, n):
    """Blom offset (rank - 3/8)/(n + 1/4), clamped inside the open unit
    interval at float32 resolution (nestmc.diagnostics._rank_to_u)."""
    u = (ranks - 0.375) / (n + 0.25)
    lo = 2.0 ** -24
    return u.clamp(lo, 1.0 - lo)


def _rank_normalize(x):
    """Average-rank (ties share the mean rank) -> standard-normal scores,
    pooled over (C*D) per trailing index."""
    shape = x.shape
    n = shape[0] * shape[1]
    flat = x.reshape(n, -1)
    s, order = torch.sort(flat, dim=0, stable=True)
    # each value's run of ties in its sorted column, [start, end], by
    # binary search (a scan along the n axis runs one thread per column on
    # the card: seconds per scalar at n = 8 M)
    st = s.T.contiguous()
    start = torch.searchsorted(st, st, side="left").T
    end = torch.searchsorted(st, st, side="right").T - 1
    avg_sorted = 0.5 * (start + end).to(x.dtype) + 1.0
    ranks = torch.empty_like(avg_sorted).scatter_(0, order, avg_sorted)
    return torch.special.ndtri(_rank_to_u(ranks, n)).reshape(shape)


def _quantile(pooled, q: float):
    """Linear-interpolation quantile over axis 0 (numpy's default), with
    jnp.quantile's arithmetic on the CPU: the position q (n - 1) and both
    weights in the draws' dtype, the low term rounded, the high term
    added to it as by a fused multiply-add (float32 draws: the product
    exact in float64, one rounding). A tail indicator x <= q then counts
    tied draws at the quantile as the reference's does."""
    n = pooled.shape[0]
    s = torch.sort(pooled, dim=0).values
    pos = torch.tensor(q, dtype=pooled.dtype) * (n - 1)
    lo = int(torch.floor(pos))
    hi = min(lo + 1, n - 1)
    w_hi = (pos - lo).to(s.device)
    w_lo = 1 - w_hi
    return ((s[lo] * w_lo).double()
            + s[hi].double() * w_hi.double()).to(s.dtype)


def rhat(draws, rank_normalized: bool = True):
    """R-hat; rank-normalized+folded variant (max of bulk/tail) by default."""
    x = torch.as_tensor(draws)
    if not rank_normalized:
        return split_rhat(x)
    z = _rank_normalize(x)
    med = _quantile(x.reshape((-1,) + tuple(x.shape[2:])), 0.5)
    zf = _rank_normalize((x - med).abs())
    return torch.maximum(split_rhat(z), split_rhat(zf))


def _autocov_fft(x):
    """Per-chain biased autocovariances via FFT. x: (M, N, ...) -> same."""
    N = x.shape[1]
    xc = x - x.mean(dim=1, keepdim=True)
    size = 1
    while size < 2 * N:
        size *= 2
    f = torch.fft.rfft(xc, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :N]
    return acov / N


def ess(draws, split: bool = True):
    """Bulk-style ESS with Geyer's initial-monotone truncation.
    draws: (C, D, ...) -> ESS per trailing index."""
    x = torch.as_tensor(draws)
    if split:
        x = _split_chains(x)
    M, N = x.shape[0], x.shape[1]
    acov = _autocov_fft(x)
    mean_acov = acov.mean(dim=0)
    w = (acov[:, 0] * N / (N - 1.0)).mean(dim=0)
    b = N * torch.var(x.mean(dim=1), dim=0, correction=1)
    var_plus = (N - 1.0) / N * w + b / N
    var_plus = torch.where(var_plus > 0, var_plus, torch.ones_like(var_plus))
    rho = 1.0 - (w - mean_acov) / var_plus
    K = N // 2
    pairs = rho[: 2 * K].reshape((K, 2) + tuple(rho.shape[1:])).sum(dim=1)
    positive = (pairs > 0.0).to(pairs.dtype).cumprod(dim=0)
    pairs = pairs * positive
    mono = torch.cummin(pairs, dim=0).values.clamp_min(0.0)
    tau = -1.0 + 2.0 * mono.sum(dim=0)
    mn = torch.tensor(float(M * N), dtype=x.dtype, device=x.device)
    tau = torch.maximum(tau, 1.0 / torch.log10(mn))
    return torch.minimum(M * N / tau, mn)


def ess_bulk(draws):
    """Rank-normalized split-chain ESS (the headline ESS)."""
    return ess(_rank_normalize(torch.as_tensor(draws)))


def ess_tail(draws, prob: float = 0.05):
    """min ESS of the two tail-quantile 0/1 indicator chains."""
    x = torch.as_tensor(draws)
    pooled = x.reshape((-1,) + tuple(x.shape[2:]))
    qlo = _quantile(pooled, prob)
    qhi = _quantile(pooled, 1.0 - prob)
    e_lo = ess((x <= qlo).to(x.dtype))
    e_hi = ess((x <= qhi).to(x.dtype))
    return torch.minimum(e_lo, e_hi)


def mcse_mean(draws):
    """Monte-Carlo standard error of the posterior mean."""
    x = torch.as_tensor(draws)
    sd = torch.std(x.reshape((-1,) + tuple(x.shape[2:])), dim=0, correction=1)
    return sd / torch.sqrt(ess(x))


def diagnose(draws_dict: dict) -> dict:
    """{name: {rhat, ess_bulk, ess_tail, mcse_mean, mean, sd}} per param."""
    out = {}
    for name, x in draws_dict.items():
        x = torch.as_tensor(x)
        pooled = x.reshape((-1,) + tuple(x.shape[2:]))
        out[name] = {
            "rhat": rhat(x),
            "ess_bulk": ess_bulk(x),
            "ess_tail": ess_tail(x),
            "mcse_mean": mcse_mean(x),
            "mean": pooled.mean(dim=0),
            "sd": torch.std(pooled, dim=0, correction=1),
        }
    return out


def diagnose_chunked(draws_dict: dict, budget_bytes: int = 2 << 30) -> dict:
    """Memory-bounded :func:`diagnose`: runs over chunks of each block's
    flattened parameters, sized so the FFT and rank temporaries (about 24
    float32 copies of a (2C, FFT size) buffer per scalar) fit the budget."""
    out = {}
    for name, x in draws_dict.items():
        x = torch.as_tensor(x)
        C, D = x.shape[0], x.shape[1]
        tail = tuple(x.shape[2:])
        P = math.prod(tail)
        size = 1 << max(1, math.ceil(math.log2(max(2 * (D // 2), 2))))
        per_scalar = 24 * 2 * C * size * 4
        chunk = max(1, min(P, budget_bytes // max(per_scalar, 1)))
        if chunk >= P:
            out[name] = diagnose({name: x})[name]
            continue
        flat = x.reshape(C, D, P)
        parts = [
            diagnose({name: flat[:, :, i: i + chunk]})[name]
            for i in range(0, P, chunk)
        ]
        out[name] = {
            k: torch.cat([p[k] for p in parts], dim=0).reshape(tail)
            for k in parts[0]
        }
    return out


# ---- streaming split R-hat, standard layout ------------------------------

def streaming_rhat_init(position: dict) -> dict:
    """Zero Welford accumulators {name: (count (2,) host, mean, m2)} with
    mean/m2 (C, 2, ...) on the position's device."""
    out = {}
    for name, x in position.items():
        shape = (x.shape[0], 2) + tuple(x.shape[1:])
        out[name] = (
            torch.zeros(2, dtype=torch.float32),
            torch.zeros(shape, dtype=torch.float32, device=x.device),
            torch.zeros(shape, dtype=torch.float32, device=x.device),
        )
    return out


def streaming_rhat_update(acc: dict, position: dict, idx: int,
                          half_len: int) -> dict:
    """Fold retained draw ``idx`` (host int): draws [0, half_len) go to
    half 0, [half_len, 2 half_len) to half 1, the odd leftover is dropped
    (split_rhat's convention)."""
    if idx >= 2 * half_len:
        return acc
    h = 0 if idx < half_len else 1
    out = {}
    for name, (count, mean, m2) in acc.items():
        x = position[name].float()
        cnt = float(count[h]) + 1.0
        delta = x - mean[:, h]
        new_mean_h = mean[:, h] + delta / cnt
        new_m2_h = m2[:, h] + delta * (x - new_mean_h)
        count = count.clone()
        count[h] = cnt
        mean = mean.clone()
        m2 = m2.clone()
        mean[:, h] = new_mean_h
        m2[:, h] = new_m2_h
        out[name] = (count, mean, m2)
    return out


def streaming_rhat_table(count, idxs, half_len: int):
    """((n, 2) act, (n, 2) cnt, count after) of the device-table form of
    :func:`streaming_rhat_update` for n retained draws in turn: idxs[i] the
    i-th draw's index among the folded draws (None: the draw is not
    folded, as a draw that full_rhat_thin skips). act[i, h] is 1 for the
    half the draw folds into (none past 2 half_len) and cnt[i] the count
    each half has after it, as float32 host tensors; ``count`` (2,) the
    counts before the first."""
    count = torch.as_tensor(count, dtype=torch.float32).cpu().clone()
    act = torch.zeros(len(idxs), 2, dtype=torch.float32)
    cnt = torch.empty(len(idxs), 2, dtype=torch.float32)
    for i, idx in enumerate(idxs):
        if idx is not None and idx < 2 * half_len:
            h = 0 if idx < half_len else 1
            act[i, h] = 1.0
            count[h] = float(count[h]) + 1.0
        cnt[i] = torch.clamp_min(count, 1.0)
    return act, cnt, count


def streaming_rhat_update_at(acc: dict, position: dict, act, cnt) -> dict:
    """{name: (mean', m2')}: :func:`streaming_rhat_update`'s means and M2s
    with the draw's half and count read from tensors on their device (a
    row of :func:`streaming_rhat_table`), so one captured program folds
    every draw; the same bits. The half whose flag is set is gathered,
    updated and written into copies of mean and m2 (none set: both keep
    their values); the counts stay with the caller. Dividing by a Python
    float is a float32 division on the CPU and a multiply by the float32
    reciprocal on the card, so the card's quotient is one."""
    h = (act[1] > 0).long().reshape(1)
    on = act.index_select(0, h) > 0
    c = cnt.index_select(0, h)
    out = {}
    for name, (_, mean, m2) in acc.items():
        x = position[name].float()
        shape = (1,) * x.ndim
        mean_h = mean.index_select(1, h).squeeze(1)
        m2_h = m2.index_select(1, h).squeeze(1)
        delta = x - mean_h
        step = (delta * torch.reciprocal(c.reshape(shape)) if mean.is_cuda
                else delta / c.reshape(shape))
        new_mean = mean_h + step
        new_m2 = m2_h + delta * (x - new_mean)
        keep = on.reshape(shape)
        mean, m2 = mean.clone(), m2.clone()
        mean.index_copy_(1, h, torch.where(keep, new_mean, mean_h)
                         .unsqueeze(1))
        m2.index_copy_(1, h, torch.where(keep, new_m2, m2_h).unsqueeze(1))
        out[name] = (mean, m2)
    return out


# ---- kernel-layout (fold) accumulators -----------------------------------

def fold_rhat_init(position: dict, names) -> dict:
    """Kernel-layout accumulators (2, *dims, C) for the named leaves."""
    out = {}
    for name in names:
        x = position[name]
        shape = (2,) + tuple(x.shape[1:]) + (x.shape[0],)
        out[name] = (
            torch.zeros(2, dtype=torch.float32),
            torch.zeros(shape, dtype=torch.float32, device=x.device),
            torch.zeros(shape, dtype=torch.float32, device=x.device),
        )
    return out


def fold_rhat_scalars(count, jm1: int, half_len: int):
    """(2, 2) host float32 [[cnt_new_0, active_0], [cnt_new_1, active_1]]
    for folding retained draw ``jm1`` (-1 = nothing pending); cnt_new is
    clamped >= 1 so the division is always safe."""
    count = torch.as_tensor(count, dtype=torch.float32).cpu()
    h = 0 if jm1 < half_len else 1
    act = 1.0 if 0 <= jm1 < 2 * half_len else 0.0
    act_h = torch.tensor(
        [act * (h == 0), act * (h == 1)], dtype=torch.float32
    )
    cnt_new = torch.clamp_min(count + act_h, 1.0)
    return torch.stack([cnt_new, act_h], dim=-1)


def fold_rhat_table(count, jm1s, half_len: int):
    """((n, 2, 2) scalars, count after): :func:`fold_rhat_scalars` for
    folding retained draws jm1s[0], jm1s[1], ... in turn (-1: nothing
    pending), each at the count its predecessors leave, the count advanced
    by each one's flags as the engine advances it."""
    count = torch.as_tensor(count, dtype=torch.float32).cpu()
    rows = []
    for jm1 in jm1s:
        sc = fold_rhat_scalars(count, jm1, half_len)
        rows.append(sc)
        count = count + sc[:, 1]
    if not rows:
        return torch.empty(0, 2, 2), count
    return torch.stack(rows), count


def fold_rhat_update(mean, m2, x_t, scalars):
    """Plain both-halves Welford fold (the kernel's reference).
    mean/m2 (2, *dims, C); x_t (*dims, C); scalars (2, 2)."""
    nd = mean.ndim - 1
    sc = torch.as_tensor(scalars, dtype=torch.float32).to(mean.device)
    cnt = sc[:, 0].reshape((2,) + (1,) * nd)
    act = sc[:, 1].reshape((2,) + (1,) * nd)
    delta = x_t[None] - mean
    new_mean = mean + act * delta / cnt
    new_m2 = m2 + act * delta * (x_t[None] - new_mean)
    return new_mean, new_m2


def _std_sequences(count, mean, m2, chain_axis: int = 0):
    """(n, seq_mean (2C, ...), seq_var (2C, ...)) from standard layout:
    mean/m2 with the half axis at 1, after the leaf's leading axis;
    ``chain_axis`` is the chains' axis in the position leaf."""
    n = max(float(count[0]), 2.0)
    cdim = 0 if chain_axis == 0 else chain_axis + 1
    mean_hc = mean.movedim((1, cdim), (0, 1))
    m2_hc = m2.movedim((1, cdim), (0, 1))
    return n, *_sequences(count, mean_hc, m2_hc)


def _fold_sequences(count, mean, m2):
    """Same, from kernel-layout accumulators (mean/m2 (2, *dims, C))."""
    n = max(float(count[0]), 2.0)
    return n, *_sequences(count, mean.movedim(-1, 1), m2.movedim(-1, 1))


def _sequences(count, mean_hc, m2_hc):
    seq_mean = mean_hc.reshape((-1,) + tuple(mean_hc.shape[2:]))
    cnt = torch.as_tensor(count, dtype=torch.float32).to(mean_hc.device)
    cnt = cnt.reshape((2,) + (1,) * (mean_hc.ndim - 1))
    seq_var = (m2_hc / torch.clamp_min(cnt - 1.0, 1.0)).reshape(
        seq_mean.shape
    )
    return seq_mean, seq_var


def _rhat_from_sequences(n, seq_mean, seq_var):
    w = seq_var.mean(dim=0)
    b = n * torch.var(seq_mean, dim=0, correction=1)
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))


def streaming_rhat_finalize(acc: dict, chain_axes: dict | None = None) -> dict:
    """{name: classic split R-hat over the block's non-chain dims}.

    chain_axes: {name: axis of the chains in the position leaf} (default
    0): the Welford update is elementwise, so accumulators of a
    chains-minor leaf (e.g. beta (G, p, C), axis 2) pool the same way
    once this step knows where the chains are."""
    return {
        name: _rhat_from_sequences(*_std_sequences(
            *a, 0 if chain_axes is None else chain_axes.get(name, 0)))
        for name, a in acc.items()
    }


def fold_rhat_finalize(acc: dict) -> dict:
    """{name: split R-hat} from kernel-layout accumulators."""
    return {
        name: _rhat_from_sequences(*_fold_sequences(*a))
        for name, a in acc.items()
    }


# ---- streaming cross-chain ESS -------------------------------------------

def _chi2_lower_quantile(k, alpha: float):
    """Wilson-Hilferty chi^2_{alpha, k} approximation, float32."""
    z = torch.special.ndtri(torch.tensor(alpha, dtype=torch.float32))
    k = torch.tensor(float(k), dtype=torch.float32)
    c = 2.0 / (9.0 * k)
    return k * (1.0 - c + z * torch.sqrt(c)) ** 3


def _cross_chain_ess(n, seq_mean, seq_var, alpha: float):
    """(ess_hat, ess_lb) from M sequences' means/variances (axis 0): the
    multi-chain ESS M n var_plus / B, B = n Var(seq means), capped at M n,
    and its one-sided (1 - alpha) chi^2 lower bound."""
    M = seq_mean.shape[0]
    w = seq_var.mean(dim=0)
    b = n * torch.var(seq_mean, dim=0, correction=1)
    var_plus = (n - 1.0) / n * w + b / n
    cap = float(M) * n
    ess_hat = torch.clamp_max(M * n * var_plus / b.clamp_min(1e-30), cap)
    k = M - 1
    shrink = (_chi2_lower_quantile(k, alpha) / k).to(ess_hat.device)
    return ess_hat, ess_hat * shrink


def streaming_ess_finalize(acc: dict, alpha: float = 0.05) -> dict:
    """{name: {"ess", "ess_lb"}} over every unit of standard-layout blocks."""
    out = {}
    for name, a in acc.items():
        e, lb = _cross_chain_ess(*_std_sequences(*a), alpha)
        out[name] = {"ess": e, "ess_lb": lb}
    return out


def fold_ess_finalize(acc: dict, alpha: float = 0.05) -> dict:
    """Same as :func:`streaming_ess_finalize`, kernel-layout accumulators."""
    out = {}
    for name, a in acc.items():
        e, lb = _cross_chain_ess(*_fold_sequences(*a), alpha)
        out[name] = {"ess": e, "ess_lb": lb}
    return out


def cross_chain_ess(draws, alpha: float = 0.05):
    """The streaming statistic on in-memory draws (C, D, ...)."""
    x = _split_chains(torch.as_tensor(draws).float())
    n = float(x.shape[1])
    return _cross_chain_ess(
        n, x.mean(dim=1), torch.var(x, dim=1, correction=1), alpha
    )
