"""One fused MALA step of the hierarchical-logistic group block on the card
(csrc/mala_accept.cu), with its plain PyTorch version.

Port of nestmc/ops/pallas/mala_accept.py::fused_mala_logistic_step. Public
layouts are the reference's: beta, g (C, G, p); v, log_scale, alpha
(C, G); mu, log_tau (C, p); fold accumulators (2, G, p, C) with (2, 2)
scalars from diagnostics.fold_rhat_scalars.

Noise: ``noise=(eps (C, G, p), logu (C, G))`` feeds both versions the same
numbers (the parity tests). Without it the kernel draws Philox noise keyed
by two words from ``rng.philox_key()``, and the plain version draws eps and
then log u from ``rng``, as kernels/mala.py does.
"""

from __future__ import annotations

import torch

from nestmc_torch.diagnostics import fold_rhat_update
from nestmc_torch.ops import loglik as _loglik
from nestmc_torch.ops.cuda import LAUNCHES, _build
from nestmc_torch.ops.cuda.common import (
    check_tensor,
    fold_scalars,
    on_cpu,
    ptr,
    stream_of,
    tile_plan,
)


def fused_mala_logistic_step_plain(
    beta, v_cache, g_cache, log_scale, mu, log_tau, x, y, mask, noise,
    rhat_fold=None,
):
    """Plain version: equals nestmc.kernels.mala.mala_update with the
    cond_cached_grad cache given the same noise, plus the fold of the input
    beta. Returns (new_beta, new_v, new_g, alpha[, mean', m2'])."""
    eps, logu = noise
    itau2 = torch.exp(-2.0 * log_tau)[:, None, :]            # (C, 1, p)
    s = torch.exp(log_scale)[..., None]
    s2 = s * s
    mu3 = mu[:, None, :]
    db = beta - mu3
    prop = beta + 0.5 * s2 * (g_cache - db * itau2) + s * eps
    v_new, g_new = _loglik.logistic_logp_grad_padded(prop, x, y, mask)
    dp = prop - mu3
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
    out = (
        torch.where(acc3, prop, beta),
        torch.where(accept, v_new, v_cache),
        torch.where(acc3, g_new, g_cache),
        torch.where(
            torch.isnan(log_alpha), torch.zeros_like(log_alpha),
            torch.exp(log_alpha.clamp_max(0.0)),
        ),
    )
    if rhat_fold is not None:
        fmean, fm2, fsc = rhat_fold
        out = out + fold_rhat_update(fmean, fm2, beta.permute(1, 2, 0), fsc)
    return out


def _launch(lib, beta, v_cache, g_cache, log_scale, mu, log_tau, x, y, mask,
            noise, key, rhat_fold, stream):
    C, G, p = beta.shape
    n = x.shape[1]
    dev = beta.device
    checks = [
        ("beta", beta, (C, G, p)), ("v_cache", v_cache, (C, G)),
        ("g_cache", g_cache, (C, G, p)), ("log_scale", log_scale, (C, G)),
        ("mu", mu, (C, p)), ("log_tau", log_tau, (C, p)),
        ("x", x, (G, n, p)), ("y", y, (G, n)), ("mask", mask, (G, n)),
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
    fsc = fold_scalars(rhat_fold)
    for name, t, shape in checks:
        check_tensor(t, name, shape, dev)
    tile_plan("mala" if noise is None else "mala_noise", n, p)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = (empty(C, G, p), empty(C, G), empty(C, G, p), empty(C, G))
    fold_out = (None, None)
    if rhat_fold is not None:
        fold_out = (empty(2, G, p, C), empty(2, G, p, C))
    k0, k1 = key if key is not None else (0, 0)
    rc = lib.nestmc_mala_step(
        ptr(x), ptr(y), ptr(mask), ptr(beta), ptr(v_cache), ptr(g_cache),
        ptr(log_scale), ptr(mu), ptr(log_tau), ptr(eps), ptr(logu),
        ptr(fmean), ptr(fm2), ptr(out[0]), ptr(out[1]), ptr(out[2]),
        ptr(out[3]), ptr(fold_out[0]), ptr(fold_out[1]), fsc[0][0], fsc[0][1],
        fsc[1][0], fsc[1][1], C, G, n, k0, k1, stream,
    )
    _build.check(rc, "mala_step")
    return out if rhat_fold is None else out + fold_out


def fused_mala_logistic_step(
    beta, v_cache, g_cache, log_scale, mu, log_tau, x, y, mask,
    rng=None, noise=None, rhat_fold=None,
):
    """One MALA update of the whole group block.

    (v_cache, g_cache): the carried likelihood value (C, G) and gradient
    (C, G, p) at beta. log_scale: (C, G) or (C, 1). rhat_fold: optional
    (mean, m2, scalars) folded with the input beta.
    Returns (new_beta, new_v, new_g, alpha (C, G)[, mean', m2']).
    """
    C, G, _ = beta.shape
    log_scale = log_scale.expand(C, G)
    if on_cpu(beta, "mala_step"):
        if noise is None:
            noise = (rng.normal(beta.shape), rng.log_uniform((C, G)))
        return fused_mala_logistic_step_plain(
            beta, v_cache, g_cache, log_scale, mu, log_tau, x, y, mask,
            noise, rhat_fold=rhat_fold,
        )
    lib = _build.library(beta.shape[-1])
    key = None if noise is not None else rng.philox_key()
    with torch.cuda.device(beta.device):
        out = _launch(
            lib, beta, v_cache, g_cache, log_scale.contiguous(), mu, log_tau,
            x, y, mask, noise, key, rhat_fold, stream_of(beta),
        )
    LAUNCHES["mala_step"] += 1
    return out
