"""Batched Newton-MH (Laplace-proposal) block update — the unfused form.

Port of :mod:`nestmc.kernels.newton`. Proposal v' ~ N(v + H(v)^-1 g(v),
c H(v)^-1) with g the gradient and H the negative Hessian of the block's
conditional, from the model's cond_cached_newton (self, rest) split; c =
exp(2 log_scale) and is never adapted. The fused kernel
(ops/cuda/newton_accept) computes the same update in one pass and is what
the sweep runs; this form is its algorithmic reference in the tests.
"""

from __future__ import annotations

import torch

from nestmc_torch.kernels.rwmh import accept_prob, as_cu, select_accepted
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.ops.smallchol import (
    chol_packed,
    half_logdet,
    lt_vec,
    solve_upper_t,
    spd_solve,
)


def newton_update(rng, block: Block, model: ModelSpec, position, log_scale,
                  data, cache=None, frozen=False):
    """One Newton-MH update of ``block`` for all chains and units.

    cache: optional carried {'v', 'g', 'h'} of the self part at the current
    value. frozen: the cached Hessian is a constant metric (requires the
    cache); the proposal's obs pass computes only (value, grad).
    Grouped blocks with a 1-D per-unit vector, value (C, U, p), or with
    scalar units, value (C, U), run as p = 1: the hooks then return grad
    and Hessian both (C, U), lifted here to (C, U, 1) and squeezed back.
    Noise: eps (C, U, p) (p = 1 for scalar units), then log u (C, U).
    Returns (new_value, alpha (C, U), new_cache).
    """
    scalar_units = bool(block.units) and len(block.unit_shape) == 0
    if not block.units or not (scalar_units or len(block.unit_shape) == 1):
        raise NotImplementedError(
            f"newton_update: block {block.name!r} needs grouped 1-D or "
            "scalar units"
        )
    p = 1 if scalar_units else int(block.unit_shape[0])
    # the algebra runs with a trailing parameter axis; the hooks see the
    # block's own shape
    ex = (lambda a: a[..., None]) if scalar_units else (lambda a: a)
    sq = (lambda a: a[..., 0]) if scalar_units else (lambda a: a)
    value = position[block.name]
    self_vgh, rest_vgh = model.cond_cached_newton[block.name]
    if cache is not None:
        sv, sg, sh = cache["v"], cache["g"], cache["h"]
    else:
        sv, sg, sh = self_vgh(value, data)
    rv_old, rg_old, rh_old = rest_vgh(value, position, data)
    d_old = sv + as_cu(rv_old, block)
    L_old = chol_packed(ex(sh + rh_old), p)
    mean_old = ex(value) + spd_solve(L_old, ex(sg + rg_old), p)
    sc = torch.exp(log_scale)[..., None]
    eps = rng.normal(mean_old.shape)
    prop = sq(mean_old + sc * solve_upper_t(L_old, eps, p))

    if frozen:
        if cache is None:
            raise ValueError("frozen Newton-MH requires a carried cache")
        # eager PyTorch has no dead-code elimination: this unfused form
        # still pays the Hessian sums the fused frozen step skips
        v_new, g_new, _ = self_vgh(prop, data)
        h_new = sh
    else:
        v_new, g_new, h_new = self_vgh(prop, data)
    rv_new, rg_new, rh_new = rest_vgh(prop, position, data)
    d_new = v_new + as_cu(rv_new, block)
    L_new = chol_packed(ex(h_new + rh_new), p)
    mean_new = ex(prop) + spd_solve(L_new, ex(g_new + rg_new), p)

    inv_c = torch.exp(-2.0 * log_scale)
    w_fwd = lt_vec(L_old, ex(prop) - mean_old, p)
    w_rev = lt_vec(L_new, ex(value) - mean_new, p)
    log_q_fwd = -0.5 * inv_c * torch.sum(w_fwd * w_fwd, dim=-1) + half_logdet(
        L_old, p
    )
    log_q_rev = -0.5 * inv_c * torch.sum(w_rev * w_rev, dim=-1) + half_logdet(
        L_new, p
    )
    log_alpha = d_new - d_old + log_q_rev - log_q_fwd

    logu = rng.log_uniform(log_alpha.shape)
    accept = logu < log_alpha                      # NaN compares False
    new_value = select_accepted(accept, prop, value, block)
    new_cache = None
    if cache is not None:
        new_cache = {
            "v": torch.where(accept, v_new, cache["v"]),
            "g": select_accepted(accept, g_new, cache["g"], block),
            "h": cache["h"] if frozen
            else select_accepted(accept, h_new, cache["h"], block),
        }
    return new_value, accept_prob(log_alpha), new_cache
