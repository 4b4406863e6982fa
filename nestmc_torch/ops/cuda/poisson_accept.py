"""The fused RW-MH, MALA and Newton-MH steps of the nested Poisson subject
block on the card (csrc/poisson_accept.cu), with their plain PyTorch
versions.

Port of nestmc/ops/pallas/poisson_accept.py::fused_rwmh_poisson_step,
::fused_mala_poisson_step and ::fused_newton_poisson_step. Public layouts
are the reference's: beta, g, bg_s (C, S, p), bg_s the per-subject prior
mean beta_g[subject_group]; lik / v, log_scale, alpha (C, S); h (C, S, T)
packed; log_tau_s (C, p). The carried loglik includes -const_s, the
per-subject sum of mask * lgamma(y + 1) (pass ``const`` (S,) to skip
recomputing it), as the reference's cache convention does.

Noise: ``noise=(eps (C, S, p), logu (C, S))`` feeds kernel, plain version
and reference the same numbers (the parity tests). Without it the kernel
draws Philox noise keyed by two words it reads from the device
(common.launch_key: ``rng``'s next key), and the plain version draws eps
and then log u from ``rng``, as the unfused updates (kernels/rwmh.py,
mala.py, newton.py) do.
"""

from __future__ import annotations

import torch

from nestmc_torch.ops import loglik as _loglik
from nestmc_torch.ops.cuda import LAUNCHES, _build, costed, step
from nestmc_torch.ops.cuda.common import (
    cell_offsets,
    check_tensor,
    launch_key,
    on_cpu,
    ptr,
    step_noise,
    stream_of,
    tile_plan,
)
from nestmc_torch.ops.smallchol import (
    chol_packed,
    half_logdet,
    lt_vec,
    pack_diag,
    solve_upper_t,
    spd_solve,
)


def _alpha(log_alpha):
    return torch.where(
        torch.isnan(log_alpha), torch.zeros_like(log_alpha),
        torch.exp(log_alpha.clamp_max(0.0)),
    )


def fused_rwmh_poisson_step_plain(beta, lik, log_scale, bg_s, log_tau_s, x,
                                  y, mask, noise, const=None):
    """Plain version: equals nestmc.kernels.rwmh.rwmh_update of beta_s
    with the cond_cached cache given the same noise (the log tau_s terms of
    the subject prior cancel in the delta). Returns (new_beta, new_lik,
    alpha)."""
    eps, logu = noise
    prop = beta + torch.exp(log_scale)[..., None] * eps
    lik_new = _loglik.poisson_loglik_padded(prop, x, y, mask, const)
    itau2 = torch.exp(-2.0 * log_tau_s)[:, None, :]
    dp = prop - bg_s
    db = beta - bg_s
    log_alpha = lik_new - lik + torch.sum(
        -0.5 * (dp * dp - db * db) * itau2, dim=-1
    )
    accept = logu < log_alpha                                # NaN rejects
    return (
        torch.where(accept[..., None], prop, beta),
        torch.where(accept, lik_new, lik),
        _alpha(log_alpha),
    )


def fused_mala_poisson_step_plain(beta, v_cache, g_cache, log_scale, bg_s,
                                  log_tau_s, x, y, mask, noise, const=None):
    """Plain version: equals nestmc.kernels.mala.mala_update of beta_s
    with the cond_cached_grad cache given the same noise. Returns
    (new_beta, new_v, new_g, alpha)."""
    eps, logu = noise
    itau2 = torch.exp(-2.0 * log_tau_s)[:, None, :]          # (C, 1, p)
    s = torch.exp(log_scale)[..., None]
    s2 = s * s
    db = beta - bg_s
    prop = beta + 0.5 * s2 * (g_cache - db * itau2) + s * eps
    v_new, g_new = _loglik.poisson_logp_grad_padded(prop, x, y, mask, const)
    dp = prop - bg_s
    d_delta = v_new - v_cache + torch.sum(
        -0.5 * (dp * dp - db * db) * itau2, dim=-1
    )
    rev = beta - prop - 0.5 * s2 * (g_new - dp * itau2)
    fwd = s * eps
    q_delta = torch.sum(fwd * fwd - rev * rev, dim=-1) / (
        2.0 * torch.exp(2.0 * log_scale)
    )
    log_alpha = d_delta + q_delta
    accept = logu < log_alpha                                # NaN rejects
    acc3 = accept[..., None]
    return (
        torch.where(acc3, prop, beta),
        torch.where(accept, v_new, v_cache),
        torch.where(acc3, g_new, g_cache),
        _alpha(log_alpha),
    )


def fused_newton_poisson_step_plain(beta, v_cache, g_cache, h_cache,
                                    log_scale, bg_s, log_tau_s, x, y, mask,
                                    noise, frozen: bool = False, const=None):
    """Plain version: equals nestmc.kernels.newton.newton_update of beta_s
    with a carried cache given the same noise. Returns (new_beta, new_v,
    new_g, new_h, alpha); frozen returns h_cache itself as new_h."""
    p = beta.shape[-1]
    eps, logu = noise
    itau2 = torch.exp(-2.0 * log_tau_s)[:, None, :]          # (C, 1, p)
    h_prior = pack_diag(itau2, p)                            # (C, 1, T)
    sc = torch.exp(log_scale)[..., None]
    inv_c = torch.exp(-2.0 * log_scale)
    db = beta - bg_s
    L_old = chol_packed(h_cache + h_prior, p)
    mean_old = beta + spd_solve(L_old, g_cache - db * itau2, p)
    prop = mean_old + sc * solve_upper_t(L_old, eps, p)
    if frozen:
        v_new, g_new = _loglik.poisson_logp_grad_padded(prop, x, y, mask,
                                                        const)
        L_new = L_old
    else:
        v_new, g_new, h_new = _loglik.poisson_logp_grad_hess_padded(
            prop, x, y, mask, const
        )
        L_new = chol_packed(h_new + h_prior, p)
    dp = prop - bg_s
    mean_new = prop + spd_solve(L_new, g_new - dp * itau2, p)
    w_rev = lt_vec(L_new, beta - mean_new, p)
    quad = torch.sum(-0.5 * (dp * dp - db * db) * itau2, dim=-1)
    log_alpha = (v_new - v_cache + quad) + 0.5 * (
        torch.sum(eps * eps, dim=-1)
        - inv_c * torch.sum(w_rev * w_rev, dim=-1)
    )
    if not frozen:
        log_alpha = log_alpha + half_logdet(L_new, p) - half_logdet(L_old, p)
    accept = logu < log_alpha                                # NaN rejects
    acc3 = accept[..., None]
    return (
        torch.where(acc3, prop, beta),
        torch.where(accept, v_new, v_cache),
        torch.where(acc3, g_new, g_cache),
        h_cache if frozen else torch.where(acc3, h_new, h_cache),
        _alpha(log_alpha),
    )


def _prepare(beta, operands, log_scale, bg_s, log_tau_s, x, y, mask, noise,
             const, kind):
    """Check every operand of a step launch and that the tile of ``kind``
    ("pois_rwmh", "pois_mala" or "pois_newton"; with external noise its
    "_noise" mode) fits; returns (const, eps, logu)."""
    C, S, p = beta.shape
    n = x.shape[1]
    T = p * (p + 1) // 2
    if const is None:
        const = _loglik.poisson_const(y, mask)
    shapes = {"lik": (C, S), "v_cache": (C, S), "g_cache": (C, S, p),
              "h_cache": (C, S, T)}
    checks = [("beta", beta, (C, S, p))]
    checks += [(k, t, shapes[k]) for k, t in operands]
    checks += [
        ("log_scale", log_scale, (C, S)), ("bg_s", bg_s, (C, S, p)),
        ("log_tau_s", log_tau_s, (C, p)), ("x", x, (S, n, p)),
        ("y", y, (S, n)), ("mask", mask, (S, n)), ("const", const, (S,)),
    ]
    eps = logu = None
    if noise is not None:
        eps, logu = noise
        checks += [("eps", eps, (C, S, p)), ("logu", logu, (C, S))]
    for name, t, shape in checks:
        check_tensor(t, name, shape, beta.device)
    tile_plan(kind if noise is None else kind + "_noise", n, p)
    return const, eps, logu


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


@costed(step("pois_rwmh_step"))
def fused_rwmh_poisson_step(beta, lik, log_scale, bg_s, log_tau_s, x, y,
                            mask, rng=None, noise=None, const=None,
                            units=None):
    """One RW-MH update of the whole subject block. lik: the carried (C, S)
    loglik at beta; log_scale (C, S) or (C, 1). units: (s0, S_total) when
    these S subjects are subjects s0.. of S_total (a group shard), so the
    noise is the unsharded run's (common.cell_offsets).
    Returns (new_beta, new_lik, alpha (C, S))."""
    C, S, p = beta.shape
    log_scale = log_scale.expand(C, S)
    if on_cpu(beta, "pois_rwmh_step"):
        if noise is None:
            noise = step_noise(rng, beta.shape, units)
        return fused_rwmh_poisson_step_plain(
            beta, lik, log_scale, bg_s, log_tau_s, x, y, mask, noise, const
        )
    lib = _build.library(p)
    key = None if noise is not None else launch_key(rng, beta.device)
    dev = beta.device
    with torch.cuda.device(dev):
        log_scale = log_scale.contiguous()
        const, eps, logu = _prepare(beta, [("lik", lik)], log_scale, bg_s,
                                    log_tau_s, x, y, mask, noise, const,
                                    "pois_rwmh")
        out = (_empty(dev, C, S, p), _empty(dev, C, S), _empty(dev, C, S))
        rc = lib.nestmc_pois_rwmh_step(
            ptr(x), ptr(y), ptr(mask), ptr(const), ptr(beta), ptr(lik),
            ptr(log_scale), ptr(bg_s), ptr(log_tau_s), ptr(eps), ptr(logu),
            *map(ptr, out), C, S, x.shape[1], ptr(key), stream_of(beta),
            *cell_offsets(rng, units, S),
        )
    _build.check(rc, "pois_rwmh_step")
    LAUNCHES["pois_rwmh_step"] += 1
    return out


@costed(step("pois_mala_step"))
def fused_mala_poisson_step(beta, v_cache, g_cache, log_scale, bg_s,
                            log_tau_s, x, y, mask, rng=None, noise=None,
                            const=None, units=None):
    """One MALA update of the whole subject block. (v_cache, g_cache): the
    carried likelihood value (C, S) and gradient (C, S, p) at beta;
    log_scale (C, S) or (C, 1). units: as in fused_rwmh_poisson_step.
    Returns (new_beta, new_v, new_g, alpha (C, S))."""
    C, S, p = beta.shape
    log_scale = log_scale.expand(C, S)
    if on_cpu(beta, "pois_mala_step"):
        if noise is None:
            noise = step_noise(rng, beta.shape, units)
        return fused_mala_poisson_step_plain(
            beta, v_cache, g_cache, log_scale, bg_s, log_tau_s, x, y, mask,
            noise, const,
        )
    lib = _build.library(p)
    key = None if noise is not None else launch_key(rng, beta.device)
    dev = beta.device
    with torch.cuda.device(dev):
        log_scale = log_scale.contiguous()
        const, eps, logu = _prepare(
            beta, [("v_cache", v_cache), ("g_cache", g_cache)], log_scale,
            bg_s, log_tau_s, x, y, mask, noise, const, "pois_mala",
        )
        out = (_empty(dev, C, S, p), _empty(dev, C, S),
               _empty(dev, C, S, p), _empty(dev, C, S))
        rc = lib.nestmc_pois_mala_step(
            ptr(x), ptr(y), ptr(mask), ptr(const), ptr(beta), ptr(v_cache),
            ptr(g_cache), ptr(log_scale), ptr(bg_s), ptr(log_tau_s),
            ptr(eps), ptr(logu), *map(ptr, out), C, S, x.shape[1], ptr(key),
            stream_of(beta), *cell_offsets(rng, units, S),
        )
    _build.check(rc, "pois_mala_step")
    LAUNCHES["pois_mala_step"] += 1
    return out


def _newton_name(a) -> str:
    return ("pois_newton_step_frozen" if a["frozen"]
            else "pois_newton_step_refresh")


@costed(step(_newton_name))
def fused_newton_poisson_step(beta, v_cache, g_cache, h_cache, log_scale,
                              bg_s, log_tau_s, x, y, mask, rng=None,
                              noise=None, frozen: bool = False, const=None,
                              units=None):
    """One Newton-MH update of the whole subject block. log_scale: (C, S)
    or (C, 1) log sqrt(c). frozen: h_cache is a constant metric; the obs
    pass skips the Hessian and new_h is h_cache itself. units: as in
    fused_rwmh_poisson_step.
    Returns (new_beta, new_v, new_g, new_h, alpha (C, S))."""
    C, S, p = beta.shape
    T = p * (p + 1) // 2
    log_scale = log_scale.expand(C, S)
    if on_cpu(beta, "pois_newton_step"):
        if noise is None:
            noise = step_noise(rng, beta.shape, units)
        return fused_newton_poisson_step_plain(
            beta, v_cache, g_cache, h_cache, log_scale, bg_s, log_tau_s,
            x, y, mask, noise, frozen=frozen, const=const,
        )
    lib = _build.library(p)
    key = None if noise is not None else launch_key(rng, beta.device)
    dev = beta.device
    with torch.cuda.device(dev):
        log_scale = log_scale.contiguous()
        const, eps, logu = _prepare(
            beta, [("v_cache", v_cache), ("g_cache", g_cache),
                   ("h_cache", h_cache)],
            log_scale, bg_s, log_tau_s, x, y, mask, noise, const,
            "pois_newton",
        )
        out_beta, out_v, out_g, out_alpha = (
            _empty(dev, C, S, p), _empty(dev, C, S), _empty(dev, C, S, p),
            _empty(dev, C, S),
        )
        out_h = None if frozen else _empty(dev, C, S, T)
        rc = lib.nestmc_pois_newton_step(
            ptr(x), ptr(y), ptr(mask), ptr(const), ptr(beta), ptr(v_cache),
            ptr(g_cache), ptr(h_cache), ptr(log_scale), ptr(bg_s),
            ptr(log_tau_s), ptr(eps), ptr(logu), ptr(out_beta), ptr(out_v),
            ptr(out_g), ptr(out_h), ptr(out_alpha), C, S, x.shape[1],
            ptr(key), int(frozen), stream_of(beta),
            *cell_offsets(rng, units, S),
        )
    kname = ("pois_newton_step_frozen" if frozen
             else "pois_newton_step_refresh")
    _build.check(rc, kname)
    LAUNCHES[kname] += 1
    return (out_beta, out_v, out_g, h_cache if frozen else out_h, out_alpha)
