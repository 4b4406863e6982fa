"""Warmup adaptation: Robbins-Monro proposal-scale tuning and the
diagonal or full preconditioner.

Port of :mod:`nestmc.adapt`. Adaptation runs only in warmup and freezes
when sampling begins:

  log s_{t+1} = log s_t + c (t + 1 + t0)^(-kappa) (alpha_t - alpha*)

with kappa = 0.6, t0 = 10, c = 1 by default; alpha* = 0.234 / 0.44 (RW by
dimension) or 0.574 (MALA). ``t`` counts sweeps from 0 and is a host int;
a captured sweep reads its gain from a device table of rm_step_size(t)
instead (nestmc_torch/segments.py), the same float32 multiplier.
The preconditioner state of a block (KernelState.precond) is an EMA of the
posterior moments per (chain, unit): the diagonal variance ('diag') or the
Haario covariance ('full'), which falls back to 'diag' for scalar units.
"""

from __future__ import annotations

import torch

from nestmc_torch.config import KernelConfig


def rm_step_size(t: int, cfg: KernelConfig) -> float:
    """Robbins-Monro gain at adaptation step t (0-based)."""
    return cfg.adapt_c * (t + 1.0 + cfg.adapt_t0) ** (-cfg.adapt_kappa)


def adapt_log_scale(log_scale, alpha, t: int, target: float,
                    cfg: KernelConfig, gain=None):
    """One RM update of per-(chain, unit) log proposal scales, clipped to
    [-12, 8]. alpha: (C, U) realised acceptance probabilities this sweep.
    gain: the step's gain as a float32 tensor on alpha's device (a
    captured sweep's entry of the segment's table), in place of
    rm_step_size(t); the product is the same float32 product."""
    if gain is None:
        gain = rm_step_size(t, cfg)
    new = log_scale + gain * (alpha - target)
    return torch.clamp(new, -12.0, 8.0)


def init_precond(value, cfg: KernelConfig, unit_dim: int = 1):
    """None ('none'), {'mean', 'var', 'count'} ('diag', or 'full' with
    scalar units) or {'mean', 'cov' (value.shape + (d,)), 'count'}
    ('full'; d = value.shape[-1]); count is (C,)."""
    count = torch.zeros(value.shape[:1], dtype=value.dtype,
                        device=value.device)
    if cfg.precond == "full" and unit_dim > 1:
        d = value.shape[-1]
        eye = torch.eye(d, dtype=value.dtype, device=value.device)
        return {"mean": value.clone(),
                "cov": eye.expand(tuple(value.shape) + (d,)).clone(),
                "count": count}
    if cfg.precond in ("diag", "full"):
        return {"mean": value.clone(), "var": torch.ones_like(value),
                "count": count}
    return None


def update_precond(pc, value, cfg: KernelConfig):
    """EMA update (decay precond_decay) of the moment estimates."""
    if pc is None:
        return None
    g = cfg.precond_decay
    mean = pc["mean"] + g * (value - pc["mean"])
    if "cov" in pc:
        d_new = value - mean
        d_old = value - pc["mean"]
        outer = d_new[..., :, None] * d_old[..., None, :]
        cov = pc["cov"] + g * (outer - pc["cov"])
        return {"mean": mean, "cov": cov, "count": pc["count"] + 1.0}
    var = pc["var"] + g * ((value - mean) * (value - pc["mean"]) - pc["var"])
    return {"mean": mean, "var": var, "count": pc["count"] + 1.0}


def _ready_gate(pc, like, warm_steps: int):
    """1 for the chains whose EMA has seen ``warm_steps`` updates, else 0,
    shaped to broadcast against ``like``."""
    ready = (pc["count"] >= warm_steps).to(like.dtype)
    return ready.reshape(tuple(ready.shape) + (1,) * (like.ndim - 1))


def precond_std(pc, cfg: KernelConfig, warm_steps: int = 50):
    """The proposal's shape multiplier: None, the per-coordinate std
    (diag) or the lower Cholesky factor of the EMA covariance plus
    precond_reg I (full; per (chain, unit), NaN where the matrix is not
    positive definite, as the reference's jnp.linalg.cholesky gives, and
    with no host read of the factorization's status, so a captured sweep
    can take it); the identity until the chain's EMA has seen
    ``warm_steps`` sweeps. The RW and MALA updates apply a diag multiplier
    elementwise and a full factor as eps -> L eps over the trailing dim
    (the extra matrix dim tells)."""
    if pc is None:
        return None
    if "cov" in pc:
        cov = pc["cov"]
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        chol, info = torch.linalg.cholesky_ex(cov + cfg.precond_reg * eye)
        chol = torch.where((info == 0)[..., None, None], chol, float("nan"))
        ready = _ready_gate(pc, cov, warm_steps)
        return ready * chol + (1.0 - ready) * eye
    std = torch.sqrt(pc["var"] + cfg.precond_reg)
    ready = _ready_gate(pc, std, warm_steps)
    return ready * std + (1.0 - ready)
