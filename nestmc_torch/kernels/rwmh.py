"""Helpers shared by the MH block updates (port of the helper part of
:mod:`nestmc.kernels.rwmh`; the RW-MH update itself is not ported yet)."""

from __future__ import annotations

import torch

from nestmc_torch.model import Block


def as_cu(d, block: Block):
    """Normalise a conditional log-density to (C, U) (U = 1 for scalar
    blocks)."""
    return d if block.units else d[:, None]


def accept_prob(log_alpha):
    """min(1, exp(log_alpha)) with NaN -> 0 (NaN proposals must reject)."""
    a = torch.exp(log_alpha.clamp_max(0.0))
    return torch.where(torch.isnan(log_alpha), torch.zeros_like(a), a)


def select_accepted(accept_cu, prop, value, block: Block):
    """Per-unit where() between proposal and current value."""
    if block.units:
        m = accept_cu.reshape(
            tuple(accept_cu.shape) + (1,) * len(block.unit_shape)
        )
    else:
        m = accept_cu.reshape(
            (accept_cu.shape[0],) + (1,) * len(block.unit_shape)
        )
    return torch.where(m, prop, value)
