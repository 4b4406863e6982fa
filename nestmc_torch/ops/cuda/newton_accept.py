"""One fused Newton-MH step of the hierarchical-logistic group block on the
card (csrc/newton_accept.cu), with its plain PyTorch version.

Port of nestmc/ops/pallas/newton_accept.py::fused_newton_logistic_step.
Public layouts are the reference's: beta, g (C, G, p); v, log_scale,
alpha (C, G); h (C, G, T) packed; mu, log_tau (C, p); fold accumulators
(2, G, p, C) with (2, 2) scalars from diagnostics.fold_rhat_scalars.

Noise: ``noise=(eps (C, G, p), logu (C, G))`` feeds both versions the same
numbers (the parity tests). Without it the kernel draws Philox noise keyed
by two words it reads from the device (common.launch_key: ``rng``'s next
key), and the plain version draws eps and log u from ``rng``. The fold's
scalars, too, reach the kernel through device memory, so a captured launch
reads each replay's.
"""

from __future__ import annotations

import torch

from nestmc_torch.diagnostics import fold_rhat_update
from nestmc_torch.ops import loglik as _loglik
from nestmc_torch.ops.cuda import LAUNCHES, _build, costed, step
from nestmc_torch.ops.cuda.common import (
    cell_offsets,
    check_tensor,
    fold_scalars,
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


def fused_newton_logistic_step_plain(
    beta, v_cache, g_cache, h_cache, log_scale, mu, log_tau, x, y, mask,
    noise, frozen: bool = False, rhat_fold=None,
):
    """Plain version: equals nestmc.kernels.newton.newton_update with a
    carried cache, plus the fold of the input beta. Returns (new_beta,
    new_v, new_g, new_h, alpha[, mean', m2']); frozen returns h_cache
    itself as new_h."""
    C, G, p = beta.shape
    eps, logu = noise
    itau2 = torch.exp(-2.0 * log_tau)[:, None, :]           # (C, 1, p)
    h_prior = pack_diag(itau2, p)                           # (C, 1, T)
    sc = torch.exp(log_scale)[..., None]
    inv_c = torch.exp(-2.0 * log_scale)
    db = beta - mu[:, None, :]
    L_old = chol_packed(h_cache + h_prior, p)
    mean_old = beta + spd_solve(L_old, g_cache - db * itau2, p)
    prop = mean_old + sc * solve_upper_t(L_old, eps, p)
    if frozen:
        v_new, g_new = _loglik.logistic_logp_grad_padded(prop, x, y, mask)
        L_new = L_old
    else:
        v_new, g_new, h_new = _loglik.logistic_logp_grad_hess_padded(
            prop, x, y, mask
        )
        L_new = chol_packed(h_new + h_prior, p)
    dp = prop - mu[:, None, :]
    mean_new = prop + spd_solve(L_new, g_new - dp * itau2, p)
    w_rev = lt_vec(L_new, beta - mean_new, p)
    quad = torch.sum(-0.5 * (dp * dp - db * db) * itau2, dim=-1)
    log_alpha = (v_new - v_cache + quad) + 0.5 * (
        torch.sum(eps * eps, dim=-1)
        - inv_c * torch.sum(w_rev * w_rev, dim=-1)
    )
    if not frozen:
        log_alpha = log_alpha + half_logdet(L_new, p) - half_logdet(L_old, p)
    accept = logu < log_alpha                               # NaN rejects
    acc3 = accept[..., None]
    out = (
        torch.where(acc3, prop, beta),
        torch.where(accept, v_new, v_cache),
        torch.where(acc3, g_new, g_cache),
        h_cache if frozen else torch.where(acc3, h_new, h_cache),
        torch.where(
            torch.isnan(log_alpha), torch.zeros_like(log_alpha),
            torch.exp(log_alpha.clamp_max(0.0)),
        ),
    )
    if rhat_fold is not None:
        fmean, fm2, fsc = rhat_fold
        out = out + fold_rhat_update(fmean, fm2, beta.permute(1, 2, 0), fsc)
    return out


def _launch(lib, beta, v_cache, g_cache, h_cache, log_scale, mu, log_tau,
            x, y, mask, noise, key, frozen, rhat_fold, stream, offsets):
    C, G, p = beta.shape
    n = x.shape[1]
    T = p * (p + 1) // 2
    dev = beta.device
    checks = [
        ("beta", beta, (C, G, p)), ("v_cache", v_cache, (C, G)),
        ("g_cache", g_cache, (C, G, p)), ("h_cache", h_cache, (C, G, T)),
        ("log_scale", log_scale, (C, G)), ("mu", mu, (C, p)),
        ("log_tau", log_tau, (C, p)), ("x", x, (G, n, p)),
        ("y", y, (G, n)), ("mask", mask, (G, n)),
    ]
    eps = logu = None
    if noise is not None:
        eps, logu = noise
        checks += [("eps", eps, (C, G, p)), ("logu", logu, (C, G))]
    fmean = fm2 = None
    if rhat_fold is not None:
        fmean, fm2, _ = rhat_fold
        checks += [("fold mean", fmean, (2, G, p, C)),
                   ("fold m2", fm2, (2, G, p, C))]
    fsc = fold_scalars(rhat_fold, dev)
    for name, t, shape in checks:
        check_tensor(t, name, shape, dev)
    tile_plan("newton" if noise is None else "newton_noise", n, p)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out_beta, out_v, out_g, out_alpha = (
        empty(C, G, p), empty(C, G), empty(C, G, p), empty(C, G)
    )
    out_h = None if frozen else empty(C, G, T)
    out_fmean = out_fm2 = None
    if rhat_fold is not None:
        out_fmean, out_fm2 = empty(2, G, p, C), empty(2, G, p, C)
    rc = lib.nestmc_newton_step(
        ptr(x), ptr(y), ptr(mask), ptr(beta), ptr(v_cache), ptr(g_cache),
        ptr(h_cache), ptr(log_scale), ptr(mu), ptr(log_tau), ptr(eps),
        ptr(logu), ptr(fmean), ptr(fm2), ptr(out_beta), ptr(out_v),
        ptr(out_g), ptr(out_h), ptr(out_alpha), ptr(out_fmean),
        ptr(out_fm2), ptr(fsc), C, G, n, ptr(key), int(frozen), stream,
        *offsets,
    )
    _build.check(rc, "newton_step")
    out = (out_beta, out_v, out_g, h_cache if frozen else out_h, out_alpha)
    if rhat_fold is not None:
        out = out + (out_fmean, out_fm2)
    return out


def _newton_name(a) -> str:
    return "newton_step_frozen" if a["frozen"] else "newton_step_refresh"


@costed(step(_newton_name))
def fused_newton_logistic_step(
    beta, v_cache, g_cache, h_cache, log_scale, mu, log_tau, x, y, mask,
    rng=None, noise=None, frozen: bool = False, rhat_fold=None, units=None,
):
    """One Newton-MH update of the whole group block.

    log_scale: (C, G) or (C, 1) log sqrt(c). frozen: h_cache is a constant
    metric; the obs pass skips the Hessian and new_h is h_cache itself.
    rhat_fold: optional (mean, m2, scalars) folded with the input beta.
    units: (g0, G_total) of a group shard, as in
    mh_accept.fused_rwmh_logistic_step.
    Returns (new_beta, new_v, new_g, new_h, alpha[, mean', m2']).
    """
    C, G, _ = beta.shape
    log_scale = log_scale.expand(C, G)
    if on_cpu(beta, "newton_step"):
        if noise is None:
            noise = step_noise(rng, beta.shape, units)
        return fused_newton_logistic_step_plain(
            beta, v_cache, g_cache, h_cache, log_scale, mu, log_tau, x, y,
            mask, noise, frozen=frozen, rhat_fold=rhat_fold,
        )
    lib = _build.library(beta.shape[-1])
    key = None if noise is not None else launch_key(rng, beta.device)
    with torch.cuda.device(beta.device):
        out = _launch(
            lib, beta, v_cache, g_cache, h_cache, log_scale.contiguous(),
            mu, log_tau, x, y, mask, noise, key, frozen, rhat_fold,
            stream_of(beta), cell_offsets(rng, units, G),
        )
    LAUNCHES["newton_step_frozen" if frozen else "newton_step_refresh"] += 1
    return out


def philox_probe(count: int, key, device, p: int = 4):
    """(normal, uniform) from the kernels' Philox helper, one cell each:
    the statistics probe of the in-kernel generator (CUDA only). The
    helper does not depend on p; ``p`` picks which built library runs it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("philox_probe: the Philox helper runs on CUDA")
    lib = _build.library(p)
    normal = torch.empty(count, dtype=torch.float32, device=device)
    uniform = torch.empty(count, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.nestmc_philox_probe(
            ptr(normal), ptr(uniform), count, key[0], key[1],
            stream_of(normal),
        )
    _build.check(rc, "philox_probe")
    return normal, uniform
