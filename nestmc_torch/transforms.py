"""Bijective reparameterizations for constrained parameters (port of
:mod:`nestmc.transforms`).

The sampler works in unconstrained space; a constrained parameter (a
scale > 0, a probability in (0, 1)) is mapped through one of these
bijectors, and its log-Jacobian is added to the target log density, so a
random-walk proposal never leaves the support.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Transform:
    """y = forward(x): unconstrained x -> constrained y.

    ``log_jac(x)`` is log |dy/dx| elementwise, to be ADDED to the target
    density written in terms of the constrained variable.
    """

    name: str
    forward: Callable
    inverse: Callable
    log_jac: Callable


identity = Transform(
    name="identity",
    forward=lambda x: x,
    inverse=lambda y: y,
    log_jac=torch.zeros_like,
)

# exp: x in R -> y > 0;  log|dy/dx| = x
log_transform = Transform(
    name="log",
    forward=torch.exp,
    inverse=torch.log,
    log_jac=lambda x: x,
)

# sigmoid: x in R -> y in (0,1); log|dy/dx| = -softplus(x) - softplus(-x)
logit_transform = Transform(
    name="logit",
    forward=torch.sigmoid,
    inverse=lambda y: torch.log(y) - torch.log1p(-y),
    log_jac=lambda x: -F.softplus(x) - F.softplus(-x),
)

# softplus: x in R -> y > 0; log|dy/dx| = log(sigmoid(x)) = -softplus(-x)
softplus_transform = Transform(
    name="softplus",
    forward=F.softplus,
    inverse=lambda y: torch.log(-torch.expm1(-y)) + y,
    log_jac=lambda x: -F.softplus(-x),
)

TRANSFORMS = {
    t.name: t
    for t in (identity, log_transform, logit_transform, softplus_transform)
}


def get(name: str) -> Transform:
    return TRANSFORMS[name]
