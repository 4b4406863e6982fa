"""Log-density building blocks used by the ported models."""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)
_LOG_PI = math.log(math.pi)


def _log(scale):
    return torch.log(scale) if torch.is_tensor(scale) else math.log(scale)


def logpdf_normal(x, loc=0.0, scale=1.0):
    """log N(x | loc, scale); broadcasts over tensors and floats."""
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - _log(scale)


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


def log_scale_guard(log_scale, bound: float = 12.0):
    """0 inside |x| < bound, -inf outside: keeps exp(+/-2 log tau) finite
    in float32 (see nestmc.distributions.log_scale_guard)."""
    return torch.where(
        log_scale.abs() < bound,
        torch.zeros_like(log_scale),
        torch.full_like(log_scale, -math.inf),
    )
