"""Warmup adaptation: Robbins-Monro proposal-scale tuning.

Port of the scale part of :mod:`nestmc.adapt` (preconditioning is not
ported; config.validate raises on precond != 'none'). Adaptation runs only
in warmup and freezes when sampling begins:

  log s_{t+1} = log s_t + c (t + 1 + t0)^(-kappa) (alpha_t - alpha*)

with kappa = 0.6, t0 = 10, c = 1 by default; alpha* = 0.234 / 0.44 (RW by
dimension) or 0.574 (MALA). ``t`` counts sweeps from 0 and is a host int.
"""

from __future__ import annotations

import torch

from nestmc_torch.config import KernelConfig


def rm_step_size(t: int, cfg: KernelConfig) -> float:
    """Robbins-Monro gain at adaptation step t (0-based)."""
    return cfg.adapt_c * (t + 1.0 + cfg.adapt_t0) ** (-cfg.adapt_kappa)


def adapt_log_scale(log_scale, alpha, t: int, target: float,
                    cfg: KernelConfig):
    """One RM update of per-(chain, unit) log proposal scales, clipped to
    [-12, 8]. alpha: (C, U) realised acceptance probabilities this sweep."""
    new = log_scale + rm_step_size(t, cfg) * (alpha - target)
    return torch.clamp(new, -12.0, 8.0)
