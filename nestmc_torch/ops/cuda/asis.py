"""The hierarchical logistic model's joint (mu, log tau) interweaving move,
gradient modes, on the card (csrc/asis_move.cu), with its plain PyTorch
versions.

The move (models/hier_logistic.py) runs, between its two noise draws and
around the obs pass at the proposal:

1. :func:`asis_stats` at the current point: one row of K floats a chain,
   the sums over this rank's groups of g, g d, H (packed), H_kl d_k (k
   major), H_kl d_k d_l (packed) and, at the proposal, of the per-group
   loglik differences, d = beta - mu; then one ``groups_total`` (an
   all_reduce under group sharding);
2. :func:`asis_propose`: the Gauss-Newton metric and gradient of the
   z-fixed target from the row, the Cholesky factor, the proposal th' =
   (mu', lt') and beta' = mu' + (beta - mu) e^{lt' - lt};
3. :func:`asis_stats` at the proposal (d = (beta - mu) e^{lt' - lt}, the
   new gradient and Hessian, the loglik rows), ``groups_total`` again;
4. :func:`asis_accept`: the reverse metric and mean, the correction, the
   prior deltas, log alpha, the decision against log u and alpha.

Public layouts: beta, g (C, G, p); h (C, G, T) or (1, G, T) for a metric
every chain shares; mu, log_tau (C, p); the row (C, K) with K =
:func:`row_width` (p); eps (C, 2p); scale (C, 1) for the Langevin mode,
None for the Laplace mode (s = 1, drift 1); aux (C, p + 1): the ratios
e^{lt' - lt}, then 0.5 |eps|^2 - log det L_old. ``prior`` is the model's
population prior (models/hier_logistic.PopulationPrior): the precision
``inv_s0_2`` of mu, the log tau prior's constants (``conj``, ``a``, ``b``,
``tau_scale``, ``lp_const``, ``inv_S2``, which the kernels evaluate) and
its density, gradient and metric in log tau (``tau_logprior``, ``_grad``,
``_metric``, which the plain versions call). The CPU route runs the plain
versions, the card the kernels; any other device raises.
"""

from __future__ import annotations

import functools
import math

import torch

from nestmc_torch.distributions import log_scale_guard
from nestmc_torch.ops.cuda import LAUNCHES, _build, costed
from nestmc_torch.ops.cuda.common import check_tensor, on_cpu, ptr, stream_of
from nestmc_torch.ops.smallchol import (
    chol_packed,
    half_logdet,
    lt_vec,
    packed_dim,
    packed_index,
    solve_upper_t,
    spd_solve,
    unpack_dense,
)


def _kernel_args(prior) -> tuple:
    """The trailing arguments of the propose and accept entry points,
    from the model's population prior (see the module's docstring)."""
    return (prior.inv_s0_2, prior.a, prior.b, prior.lp_const,
            prior.tau_scale, math.log(prior.tau_scale), prior.inv_S2,
            int(prior.conj))


def row_width(p: int) -> int:
    """K: the floats of a chain's statistics row (csrc/asis_move.cu)."""
    T = packed_dim(p)
    return 2 * p + 2 * T + p * p + 1


@functools.lru_cache(maxsize=None)
def _indices(p: int, device) -> tuple:
    """On ``device``: the (p, p) packed index of each entry; the rows and
    the columns of the packed lower triangle, in packed order; the
    (2p x 2p) -> packed (2p) gather."""
    q = 2 * p

    def t(v):
        return torch.tensor(v, device=device)
    return (t([[packed_index(i, j) for j in range(p)] for i in range(p)]),
            t([i for i in range(p) for _ in range(i + 1)]),
            t([j for i in range(p) for j in range(i + 1)]),
            t([i * q + j for i in range(q) for j in range(i + 1)]))


def _check(dev, *named) -> None:
    """float32, contiguous, on ``dev`` at its shape; None entries are
    skipped."""
    for name, t, shape in named:
        if t is not None:
            check_tensor(t, name, shape, dev)


def _stats_args(beta, mu, g, h, aux, v):
    C, G, p = beta.shape
    T = packed_dim(p)
    if h.dim() != 3 or h.shape[0] not in (1, C):
        raise ValueError(f"h: shape {tuple(h.shape)}, expected (C or 1, "
                         f"{G}, {T})")
    v_new, v_old = (None, None) if v is None else v
    _check(beta.device,
           ("beta", beta, (C, G, p)), ("mu", mu, (C, p)),
           ("g", g, (C, G, p)), ("h", h, (h.shape[0], G, T)),
           ("aux", aux, (C, p + 1)), ("v_new", v_new, (C, G)),
           ("v_old", v_old, (C, G)))
    if (v_new is None) != (v_old is None):
        raise ValueError("v: give (v_new, v_old) or None")
    return v_new, v_old


def asis_stats_plain(beta, mu, g, h, aux=None, v=None):
    """(C, K) rows of the sums over the groups of ``beta``'s axis 1."""
    C, _, p = beta.shape
    full, ti, tj, _ = _indices(p, beta.device)
    d = beta - mu[:, None, :]
    if aux is not None:
        d = d * aux[:, None, :p]
    H = h[..., full]                                     # (C|1, G, p, p)
    dv = (beta.new_zeros((C, 1)) if v is None
          else torch.sum(v[0] - v[1], dim=-1, keepdim=True))
    return torch.cat([
        g.sum(1), (g * d).sum(1), h.sum(1).expand(C, -1),
        (H * d[..., :, None]).sum(1).reshape(C, p * p),
        (h * d[..., ti] * d[..., tj]).sum(1), dv,
    ], dim=-1)


def _stats_record(a) -> tuple:
    """describe() of asis_stats: n is the floats it reads a (chain, group)
    cell (utils/profiling.kernel_work)."""
    C, G, p = a["beta"].shape
    h_cell = a["h"].shape[2] if a["h"].shape[0] > 1 else 0
    return ("asis_stats", C, G,
            2 * p + h_cell + (0 if a["v"] is None else 2), p, False, False)


@costed(_stats_record)
def asis_stats(beta, mu, g, h, aux=None, v=None):
    """The (C, K) statistics rows of the move over this rank's groups (see
    the module's docstring): d = beta - mu, times aux[:, :p] (the
    proposal's ratios) when given; ``v`` = (v_new, v_old), the (C, G)
    loglik at the proposal and at the current point, or None (the row's
    last entry is then 0). The kernel on CUDA tensors, the plain version
    on CPU tensors."""
    kernel = not on_cpu(beta, "asis_stats")
    v_new, v_old = _stats_args(beta, mu, g, h, aux, v)
    if not kernel:
        return asis_stats_plain(beta, mu, g, h, aux, v)
    C, G, p = beta.shape
    lib = _build.library(p)
    with torch.cuda.device(beta.device):
        out = torch.empty((C, row_width(p)), dtype=torch.float32,
                          device=beta.device)
        rc = lib.nestmc_asis_stats(
            ptr(beta), ptr(mu), ptr(aux), ptr(g), ptr(h),
            0 if h.shape[0] == 1 else h.stride(0), ptr(v_new), ptr(v_old),
            ptr(out), C, G, stream_of(beta))
    _build.check(rc, "asis_stats")
    LAUNCHES["asis_stats"] += 1
    return out


def _metric_grad(row, mu, lt, prior):
    """The packed (C, q(q+1)/2) metric and the (C, q) gradient of the
    z-fixed target at theta = (mu, lt), q = 2p, from the rows."""
    C, p = mu.shape
    T = packed_dim(p)
    *_, qidx = _indices(p, mu.device)
    o_h, o_hd = 2 * p, 2 * p + T
    o_hdd = o_hd + p * p
    m_mm = unpack_dense(row[:, o_h:o_hd], p) + prior.inv_s0_2 * torch.eye(
        p, device=mu.device)
    m_lm = row[:, o_hd:o_hdd].reshape(C, p, p)           # [lt_k, mu_l]
    m_ll = unpack_dense(row[:, o_hdd:o_hdd + T], p) + torch.diag_embed(
        prior.tau_logprior_metric(lt))
    M = torch.cat([
        torch.cat([m_mm, m_lm.transpose(-1, -2)], dim=-1),
        torch.cat([m_lm, m_ll], dim=-1),
    ], dim=-2)
    f = torch.cat([row[:, :p] - mu * prior.inv_s0_2,
                   row[:, p:2 * p] + prior.tau_logprior_grad(lt)], dim=-1)
    return M.reshape(C, 4 * p * p)[:, qidx], f


def _steps(scale):
    """(s, drift): (1, 1) for the Laplace move, (s, s^2 / 2) for the
    Langevin move at s = scale (C, 1)."""
    if scale is None:
        return 1.0, 1.0
    return scale, 0.5 * scale * scale


def asis_propose_plain(row, mu, log_tau, eps, scale, beta, prior):
    """(th_new (C, 2p), aux (C, p + 1), beta_new (C, G, p))."""
    p = mu.shape[1]
    q = 2 * p
    M, f = _metric_grad(row, mu, log_tau, prior)
    L = chol_packed(M, q)
    s, drift = _steps(scale)
    th_old = torch.cat([mu, log_tau], dim=-1)
    th_new = (th_old + drift * spd_solve(L, f, q)
              + s * solve_upper_t(L, eps, q))
    ratio = torch.exp(th_new[:, p:] - log_tau)
    aux = torch.cat([ratio, (0.5 * torch.sum(eps * eps, dim=-1)
                             - half_logdet(L, q))[:, None]], dim=-1)
    beta_new = th_new[:, None, :p] + (beta - mu[:, None, :]) * ratio[:, None]
    return th_new, aux, beta_new


@costed(lambda a: ("asis_propose", *a["beta"].shape[:2], 0,
                   a["beta"].shape[2], False, False))
def asis_propose(row, mu, log_tau, eps, scale, beta, prior):
    """The proposal from the rows at the current point (see the module's
    docstring): (th_new, aux, beta_new). The kernel on CUDA tensors, the
    plain version on CPU tensors."""
    C, G, p = beta.shape
    kernel = not on_cpu(beta, "asis_propose")
    _check(beta.device,
           ("row", row, (C, row_width(p))), ("mu", mu, (C, p)),
           ("log_tau", log_tau, (C, p)), ("eps", eps, (C, 2 * p)),
           ("scale", scale, (C, 1)), ("beta", beta, (C, G, p)))
    if not kernel:
        return asis_propose_plain(row, mu, log_tau, eps, scale, beta, prior)
    lib = _build.library(p)
    dev = beta.device
    with torch.cuda.device(dev):
        th_new = torch.empty((C, 2 * p), dtype=torch.float32, device=dev)
        aux = torch.empty((C, p + 1), dtype=torch.float32, device=dev)
        beta_new = torch.empty_like(beta)
        rc = lib.nestmc_asis_propose(
            ptr(row), ptr(mu), ptr(log_tau), ptr(eps), ptr(scale), ptr(beta),
            ptr(th_new), ptr(aux), ptr(beta_new), C, G,
            *_kernel_args(prior), stream_of(beta))
    _build.check(rc, "asis_propose")
    LAUNCHES["asis_propose"] += 1
    return th_new, aux, beta_new


def asis_accept_plain(row, th_new, mu, log_tau, aux, scale, logu, prior):
    """(log_alpha, accept, alpha), each (C,)."""
    p = mu.shape[1]
    q = 2 * p
    mu_new, lt_new = th_new[:, :p], th_new[:, p:]
    M, f = _metric_grad(row, mu_new, lt_new, prior)
    L = chol_packed(M, q)
    s, drift = _steps(scale)
    mean_new = th_new + drift * spd_solve(L, f, q)
    w_rev = lt_vec(L, torch.cat([mu, log_tau], dim=-1) - mean_new, q)
    # the forward whitened residual is exactly s eps; the 1 / (2 s^2)
    # normalisation cancels the s
    inv_2s2 = 0.5 if scale is None else 0.5 / (s * s)[:, 0]
    q_corr = (-inv_2s2 * torch.sum(w_rev * w_rev, dim=-1)
              + half_logdet(L, q) + aux[:, p])
    prior_delta = torch.sum(
        prior.tau_logprior(lt_new) + log_scale_guard(lt_new)
        - prior.tau_logprior(log_tau), dim=-1,
    ) + torch.sum(-0.5 * (mu_new * mu_new - mu * mu) * prior.inv_s0_2,
                  dim=-1)
    log_alpha = row[:, -1] + prior_delta + q_corr
    alpha = torch.where(torch.isnan(log_alpha), torch.zeros_like(log_alpha),
                        torch.exp(log_alpha.clamp_max(0.0)))
    return log_alpha, logu < log_alpha, alpha


@costed(lambda a: ("asis_accept", a["mu"].shape[0], 0, 0, a["mu"].shape[1],
                   False, False))
def asis_accept(row, th_new, mu, log_tau, aux, scale, logu, prior):
    """The decision from the rows at the proposal (see the module's
    docstring): (log_alpha, accept (bool), alpha), each (C,); NaN (a
    metric that is not positive definite) rejects with alpha 0. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    C, p = mu.shape
    kernel = not on_cpu(mu, "asis_accept")
    _check(mu.device,
           ("row", row, (C, row_width(p))), ("th_new", th_new, (C, 2 * p)),
           ("mu", mu, (C, p)), ("log_tau", log_tau, (C, p)),
           ("aux", aux, (C, p + 1)), ("scale", scale, (C, 1)),
           ("logu", logu, (C,)))
    if not kernel:
        return asis_accept_plain(row, th_new, mu, log_tau, aux, scale, logu,
                                 prior)
    lib = _build.library(p)
    dev = mu.device
    with torch.cuda.device(dev):
        log_alpha = torch.empty((C,), dtype=torch.float32, device=dev)
        accept = torch.empty((C,), dtype=torch.bool, device=dev)
        alpha = torch.empty((C,), dtype=torch.float32, device=dev)
        rc = lib.nestmc_asis_accept(
            ptr(row), ptr(th_new), ptr(mu), ptr(log_tau), ptr(aux),
            ptr(scale), ptr(logu), ptr(log_alpha), ptr(accept), ptr(alpha),
            C, *_kernel_args(prior), stream_of(mu))
    _build.check(rc, "asis_accept")
    LAUNCHES["asis_accept"] += 1
    return log_alpha, accept, alpha
