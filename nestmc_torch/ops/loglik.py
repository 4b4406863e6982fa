"""Plain PyTorch references of the Bernoulli-logit and Poisson-log obs
passes.

Port of the padded logistic, Poisson and normal functions and the ragged
(segment) logistic and Poisson functions of :mod:`nestmc.ops.loglik`.
These are the plain versions the CUDA obs-pass kernels
(ops/cuda/loglik_logistic, ops/cuda/loglik_poisson,
ops/cuda/loglik_segment) are held against, and what those wrappers run
on CPU tensors.

Shapes:
  beta: (C, G, p)   x: (G, n, p)   y, mask: (G, n)
  loglik (C, G), grad (C, G, p), packed -Hessian (C, G, T), T = p(p+1)/2.
  Ragged: x (N, p), y (N,), segment_ids (N,) int64 sorted.

The per-observation terms use one exp and one log1p, e = exp(-|eta|):
softplus(eta) = max(eta, 0) + log1p(e), sigmoid(eta) = 1/(1+e) or e/(1+e)
by sign, w = sigmoid (1 - sigmoid) = e/(1+e)^2 — the same numbers the
kernels compute (csrc/logistic_terms.cuh). The gradient x.(y - sigmoid) is
closed form where the reference takes jax.vjp. Outputs are contiguous, so
they can feed the kernels.
"""

from __future__ import annotations

import torch


def _eta(beta, x):
    return torch.einsum("cgp,gnp->cgn", beta, x)


def _terms(eta, y, mask):
    """(ll, resid, w) per observation, masked."""
    e = torch.exp(-eta.abs())
    sp = eta.clamp_min(0.0) + torch.log1p(e)
    inv = 1.0 / (1.0 + e)
    sig = torch.where(eta >= 0.0, inv, e * inv)
    ll = (y * eta - sp) * mask
    resid = (y - sig) * mask
    w = e * inv * inv * mask
    return ll, resid, w


def xx_packed(x):
    """(G, n, T) products x_i x_j for the packed lower-triangle pairs."""
    p = x.shape[-1]
    return torch.stack(
        [x[..., i] * x[..., j] for i in range(p) for j in range(i + 1)],
        dim=-1,
    )


def xxt_packed(x, w):
    """(C, G, T) packed lower triangle of sum_i w_i x_i x_i^T over the obs
    axis: x (G, n, p), w (C, G, n); one (C, G, n) product a pair, no
    (C, G, n, p, p) temporary (nestmc.ops.loglik._xxt_packed)."""
    p = x.shape[-1]
    return torch.stack(
        [torch.sum(w * (x[..., i] * x[..., j]), dim=-1)
         for i in range(p) for j in range(i + 1)],
        dim=-1,
    )


def logistic_loglik_padded(beta, x, y, mask):
    """sum_i mask * [y*eta - softplus(eta)] -> (C, G)."""
    ll, _, _ = _terms(_eta(beta, x), y, mask)
    return ll.sum(dim=-1)


def logistic_logp_grad_padded(beta, x, y, mask):
    """((C, G) loglik, (C, G, p) grad wrt beta)."""
    ll, resid, _ = _terms(_eta(beta, x), y, mask)
    return (
        ll.sum(dim=-1),
        torch.einsum("cgn,gnp->cgp", resid, x).contiguous(),
    )


def logistic_logp_grad_hess_padded(beta, x, y, mask):
    """((C, G) loglik, (C, G, p) grad, (C, G, T) packed -Hessian
    sum_i mask w x_i x_i^T)."""
    ll, resid, w = _terms(_eta(beta, x), y, mask)
    return (
        ll.sum(dim=-1),
        torch.einsum("cgn,gnp->cgp", resid, x).contiguous(),
        torch.einsum("cgn,gnt->cgt", w, xx_packed(x)).contiguous(),
    )


def normal_loglik_padded(beta, x, y, mask, sigma):
    """Gaussian response: sum_i mask * log N(y | eta, sigma) -> (C, G).
    ``sigma`` (a float or a tensor) gets trailing axes until it is 3-D, as
    the reference broadcasts it: a scalar, (C, 1) or (C, G)."""
    eta = _eta(beta, x)
    sig = torch.as_tensor(sigma, dtype=eta.dtype, device=eta.device)
    while sig.ndim < 3:
        sig = sig[..., None]
    z = (y - eta) / sig
    ll = -0.5 * (z * z) - torch.log(sig) - 0.9189385332046727
    return torch.sum(ll * mask, dim=-1)


# ---- Ragged (segment) Bernoulli-logit and Poisson-log ----
#
# The lean per-coordinate form of the reference: eta (C, N) from p gathers
# of (C, N), each (C, N) term reduced to (C, G) over the sorted segment
# ids by a segmented sum (no atomics: the same bits on every run). No
# (C, N, p) tensor is formed (2.1 GB at C=1024, N=175k, p=3); the
# temporaries are (C, N), 0.7 GB each at that width.


def _eta_segment(beta, x, segment_ids):
    eta = beta[:, :, 0].index_select(1, segment_ids) * x[:, 0]
    for k in range(1, beta.shape[-1]):
        eta = eta + beta[:, :, k].index_select(1, segment_ids) * x[:, k]
    return eta


def _segsum(vals, segment_ids, num_groups):
    """(C, N) -> (C, G): the sum over each group's observations, in order.
    The ids are sorted, so each group is one run of columns; a segmented
    reduction sums it without the float atomics of a scatter-add, whose
    order (and so bits) on the card changes from run to run."""
    bounds = torch.arange(num_groups + 1, device=segment_ids.device)
    lengths = torch.diff(torch.searchsorted(segment_ids, bounds))
    return torch.segment_reduce(
        vals, "sum", lengths=lengths.expand(vals.shape[0], num_groups),
        axis=1, unsafe=True)


def logistic_loglik_segment(beta, x, y, segment_ids, num_groups):
    """sum over each group's obs of y*eta - softplus(eta) -> (C, G)."""
    ll, _, _ = _terms(_eta_segment(beta, x, segment_ids), y, 1.0)
    return _segsum(ll, segment_ids, num_groups)


def poisson_loglik_segment(beta, x, y, segment_ids, num_groups,
                           lgamma_y=None):
    """sum over each group's obs of y*eta - exp(eta) - lgamma(y+1) ->
    (C, G); ``lgamma_y`` an optional precomputed (N,) lgamma(y+1)."""
    eta = _eta_segment(beta, x, segment_ids)
    if lgamma_y is None:
        lgamma_y = torch.lgamma(y + 1.0)
    return _segsum(y * eta - torch.exp(eta) - lgamma_y, segment_ids,
                   num_groups)


def logistic_logp_grad_segment(beta, x, y, segment_ids, num_groups):
    """((C, G) loglik, (C, G, p) grad wrt beta)."""
    ll, resid, _ = _terms(_eta_segment(beta, x, segment_ids), y, 1.0)
    grads = [_segsum(resid * x[:, k], segment_ids, num_groups)
             for k in range(beta.shape[-1])]
    return _segsum(ll, segment_ids, num_groups), torch.stack(grads, dim=-1)


def logistic_logp_grad_hess_segment(beta, x, y, segment_ids, num_groups):
    """((C, G) loglik, (C, G, p) grad, (C, G, T) packed -Hessian)."""
    ll, resid, w = _terms(_eta_segment(beta, x, segment_ids), y, 1.0)
    p = beta.shape[-1]
    grads = [_segsum(resid * x[:, k], segment_ids, num_groups)
             for k in range(p)]
    hess = [_segsum(w * (x[:, i] * x[:, j]), segment_ids, num_groups)
            for i in range(p) for j in range(i + 1)]
    return (_segsum(ll, segment_ids, num_groups),
            torch.stack(grads, dim=-1), torch.stack(hess, dim=-1))


# ---- Poisson-log (the nested Poisson subject block) ----
#
# Units are subjects: beta (C, S, p), x (S, n, p), y and mask (S, n). One
# exp per observation gives the loglik term y eta - rate, the gradient
# weight y - rate and the curvature w = rate (csrc/poisson_terms.cuh). The
# parameter-free sum_i mask lgamma(y + 1) is the per-subject constant
# const_s (S,) (:func:`poisson_const`), subtracted once per unit; callers
# that evaluate often pass it in.


def poisson_const(y, mask):
    """(S,) sum_i mask * lgamma(y + 1)."""
    return torch.sum(torch.lgamma(y + 1.0) * mask, dim=-1)


def _pois_terms(eta, y, mask):
    rate = torch.exp(eta)
    return (y * eta - rate) * mask, (y - rate) * mask, rate * mask


def poisson_loglik_padded(beta, x, y, mask, const=None):
    """sum_i mask * [y*eta - exp(eta) - lgamma(y+1)] -> (C, S)."""
    if const is None:
        const = poisson_const(y, mask)
    ll, _, _ = _pois_terms(_eta(beta, x), y, mask)
    return ll.sum(dim=-1) - const


def poisson_logp_grad_padded(beta, x, y, mask, const=None):
    """((C, S) loglik, (C, S, p) grad sum_i mask (y - exp(eta)) x_i)."""
    if const is None:
        const = poisson_const(y, mask)
    ll, resid, _ = _pois_terms(_eta(beta, x), y, mask)
    return (
        ll.sum(dim=-1) - const,
        torch.einsum("cgn,gnp->cgp", resid, x).contiguous(),
    )


def poisson_logp_grad_hess_padded(beta, x, y, mask, const=None):
    """((C, S) loglik, (C, S, p) grad, (C, S, T) packed -Hessian
    sum_i mask exp(eta) x_i x_i^T)."""
    if const is None:
        const = poisson_const(y, mask)
    ll, resid, w = _pois_terms(_eta(beta, x), y, mask)
    return (
        ll.sum(dim=-1) - const,
        torch.einsum("cgn,gnp->cgp", resid, x).contiguous(),
        torch.einsum("cgn,gnt->cgt", w, xx_packed(x)).contiguous(),
    )
