"""One fused random-walk MH step of the hierarchical-logistic group block
on the card (csrc/mh_accept.cu), with its plain PyTorch version.

Port of nestmc/ops/pallas/mh_accept.py::fused_rwmh_logistic_step. Public
layouts are the reference's: beta (C, G, p); lik, log_scale, alpha (C, G);
mu, log_tau (C, p). Unlike the TPU kernel it takes ``noise=(eps (C, G, p),
logu (C, G))``, which feeds both versions the same numbers (the parity
tests). Without it the kernel draws Philox noise keyed by two words it
reads from the device (common.launch_key: ``rng``'s next key), and the
plain version draws eps and then log u from ``rng``, as kernels/rwmh.py
does.
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
    stream_of,
    step_noise,
    tile_plan,
)


def fused_rwmh_logistic_step_plain(beta, lik, log_scale, mu, log_tau, x, y,
                                   mask, noise):
    """Plain version: equals nestmc.kernels.rwmh.rwmh_update with the
    cond_cached cache given the same noise (the log tau terms of the group
    prior cancel in the delta). Returns (new_beta, new_lik, alpha)."""
    eps, logu = noise
    prop = beta + torch.exp(log_scale)[..., None] * eps
    lik_new = _loglik.logistic_loglik_padded(prop, x, y, mask)
    itau2 = torch.exp(-2.0 * log_tau)[:, None, :]
    dp = prop - mu[:, None, :]
    db = beta - mu[:, None, :]
    log_alpha = lik_new - lik + torch.sum(
        -0.5 * (dp * dp - db * db) * itau2, dim=-1
    )
    accept = logu < log_alpha                                # NaN rejects
    return (
        torch.where(accept[..., None], prop, beta),
        torch.where(accept, lik_new, lik),
        torch.where(
            torch.isnan(log_alpha), torch.zeros_like(log_alpha),
            torch.exp(log_alpha.clamp_max(0.0)),
        ),
    )


def _launch(lib, beta, lik, log_scale, mu, log_tau, x, y, mask, noise, key,
            stream, offsets):
    C, G, p = beta.shape
    n = x.shape[1]
    dev = beta.device
    checks = [
        ("beta", beta, (C, G, p)), ("lik", lik, (C, G)),
        ("log_scale", log_scale, (C, G)), ("mu", mu, (C, p)),
        ("log_tau", log_tau, (C, p)), ("x", x, (G, n, p)),
        ("y", y, (G, n)), ("mask", mask, (G, n)),
    ]
    eps = logu = None
    if noise is not None:
        eps, logu = noise
        checks += [("eps", eps, (C, G, p)), ("logu", logu, (C, G))]
    for name, t, shape in checks:
        check_tensor(t, name, shape, dev)
    tile_plan("rwmh" if noise is None else "rwmh_noise", n, p)
    out_beta = torch.empty((C, G, p), dtype=torch.float32, device=dev)
    out_lik = torch.empty((C, G), dtype=torch.float32, device=dev)
    out_alpha = torch.empty((C, G), dtype=torch.float32, device=dev)
    rc = lib.nestmc_rwmh_step(
        ptr(x), ptr(y), ptr(mask), ptr(beta), ptr(lik), ptr(log_scale),
        ptr(mu), ptr(log_tau), ptr(eps), ptr(logu), ptr(out_beta),
        ptr(out_lik), ptr(out_alpha), C, G, n, ptr(key), stream, *offsets,
    )
    _build.check(rc, "rwmh_step")
    return out_beta, out_lik, out_alpha


@costed(step("rwmh_step"))
def fused_rwmh_logistic_step(beta, lik, log_scale, mu, log_tau, x, y, mask,
                             rng=None, noise=None, units=None):
    """One RW-MH update of the whole group block. lik: the carried (C, G)
    loglik at beta; log_scale (C, G) or (C, 1). units: (g0, G_total) when
    these G groups are groups g0.. of G_total (a group shard), so the
    noise is the unsharded run's (common.cell_offsets; the chains' offset
    is the rng's). Returns (new_beta, new_lik, alpha (C, G))."""
    C, G, _ = beta.shape
    log_scale = log_scale.expand(C, G)
    if on_cpu(beta, "rwmh_step"):
        if noise is None:
            noise = step_noise(rng, beta.shape, units)
        return fused_rwmh_logistic_step_plain(
            beta, lik, log_scale, mu, log_tau, x, y, mask, noise
        )
    lib = _build.library(beta.shape[-1])
    key = None if noise is not None else launch_key(rng, beta.device)
    with torch.cuda.device(beta.device):
        out = _launch(lib, beta, lik, log_scale.contiguous(), mu, log_tau,
                      x, y, mask, noise, key, stream_of(beta),
                      cell_offsets(rng, units, G))
    LAUNCHES["rwmh_step"] += 1
    return out
