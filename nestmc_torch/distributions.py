"""Numerically stable log-density functions (port of
:mod:`nestmc.distributions`).

Each broadcasts over tensors of any batch shape and Python floats, as the
building blocks of a model's conditionals: the ported models use them,
and so does a user's unbatched model lifted by
:func:`nestmc_torch.model.vmap_chains`. The hot likelihood reductions
over observations are in :mod:`nestmc_torch.ops`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)
_LOG_PI = math.log(math.pi)


def _log(a):
    return torch.log(a) if torch.is_tensor(a) else math.log(a)


def _lgamma(a):
    return torch.lgamma(a) if torch.is_tensor(a) else math.lgamma(a)


def logpdf_normal(x, loc=0.0, scale=1.0):
    """log N(x | loc, scale); broadcasts over tensors and floats."""
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - _log(scale)


def logpdf_normal_prec(x, loc, prec):
    """log N(x | loc, 1/sqrt(prec)) parameterized by precision."""
    d = x - loc
    return 0.5 * (_log(prec) - _LOG_2PI - prec * d * d)


def logpdf_halfnormal(x, scale=1.0):
    """log HalfNormal(x | scale) for x >= 0 (support not checked)."""
    z = x / scale
    return -0.5 * (z * z + _LOG_2PI) + _LOG_2 - _log(scale)


def logpdf_halfcauchy(x, scale=1.0):
    """log HalfCauchy(x | scale) for x >= 0 (support not checked)."""
    z = x / scale
    return _LOG_2 - _LOG_PI - _log(scale) - torch.log1p(z * z)


def logpdf_cauchy(x, loc=0.0, scale=1.0):
    """log Cauchy(x | loc, scale)."""
    z = (x - loc) / scale
    return -_LOG_PI - _log(scale) - torch.log1p(z * z)


def logpdf_student_t(x, df, loc=0.0, scale=1.0):
    """log StudentT(x | df, loc, scale)."""
    z = (x - loc) / scale
    half = 0.5 * (df + 1.0)
    return (
        _lgamma(half)
        - _lgamma(0.5 * df)
        - 0.5 * _log(df)
        - 0.5 * _LOG_PI
        - _log(scale)
        - half * torch.log1p(z * z / df)
    )


def logpmf_bernoulli_logit(y, eta):
    """log Bernoulli(y | sigmoid(eta)) as ``y*eta - softplus(eta)``: never
    forms a probability, finite for any finite eta."""
    return y * eta - F.softplus(eta)


def logpmf_poisson_log(y, eta):
    """log Poisson(y | rate=exp(eta)): y*eta - exp(eta) - lgamma(y+1)."""
    return y * eta - torch.exp(eta) - _lgamma(y + 1.0)


def logpmf_binomial_logit(y, n, eta):
    """log Binomial(y | n, sigmoid(eta)) with the log-binomial
    coefficient, in the softplus form."""
    coef = _lgamma(n + 1.0) - _lgamma(y + 1.0) - _lgamma(n - y + 1.0)
    return coef + y * eta - n * F.softplus(eta)


def logpdf_gamma(x, shape, rate):
    """log Gamma(x | shape, rate), rate parameterization."""
    return (
        shape * _log(rate)
        - _lgamma(shape)
        + (shape - 1.0) * torch.log(x)
        - rate * x
    )


def logpdf_invgamma(x, shape, scale):
    """log InvGamma(x | shape, scale)."""
    return (
        shape * _log(scale)
        - _lgamma(shape)
        - (shape + 1.0) * torch.log(x)
        - scale / x
    )


def logpdf_exponential(x, rate=1.0):
    """log Exponential(x | rate)."""
    return _log(rate) - rate * x


def logpdf_lognormal(x, loc=0.0, scale=1.0):
    """log LogNormal(x | loc, scale) of the log's normal."""
    lx = torch.log(x)
    z = (lx - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - _log(scale) - lx


def logpdf_beta(x, a, b):
    """log Beta(x | a, b)."""
    return (
        _lgamma(a + b)
        - _lgamma(a)
        - _lgamma(b)
        + (a - 1.0) * torch.log(x)
        + (b - 1.0) * torch.log1p(-x)
    )


def log_scale_guard(log_scale, bound: float = 12.0):
    """0 inside |x| < bound, -inf outside: keeps exp(+/-2 log tau) finite
    in float32 (see nestmc.distributions.log_scale_guard)."""
    return torch.where(
        log_scale.abs() < bound,
        torch.zeros_like(log_scale),
        torch.full_like(log_scale, -math.inf),
    )


def logpdf_uniform(x, low=0.0, high=1.0):
    """-log(high - low) on [low, high], -inf outside."""
    inside = (x >= low) & (x <= high)
    val = torch.zeros_like(x) - _log(high - low)
    return torch.where(inside, val, torch.full_like(val, -math.inf))


def logpdf_mvn_diag(x, loc, scale_diag, axis=-1):
    """log MVN with diagonal covariance; reduces over ``axis``."""
    z = (x - loc) / scale_diag
    return torch.sum(
        -0.5 * (z * z + _LOG_2PI) - _log(scale_diag), dim=axis
    )


def logpdf_mvn_chol(x, loc, chol):
    """log MVN(x | loc, L L^T) given the lower-triangular Cholesky factor
    ``chol``. ``x`` and ``loc`` broadcast over leading batch axes with
    trailing dim d; ``chol`` is (..., d, d), broadcastable against them."""
    d = x.shape[-1]
    rhs = (x - loc)[..., None]
    chol_b = chol.expand(rhs.shape[:-2] + chol.shape[-2:])
    z = torch.linalg.solve_triangular(chol_b, rhs, upper=False)[..., 0]
    logdet = torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1
    )
    return -0.5 * (torch.sum(z * z, dim=-1) + d * _LOG_2PI) - logdet
