"""Masked Bernoulli-logit obs passes on the card (csrc/loglik_logistic.cu).

Port of nestmc/ops/pallas/loglik_logistic.py::logistic_logp_grad_pallas,
::logistic_logp_grad_hess_pallas and ::logistic_loglik_padded_pallas, with
the same public layouts: beta (C, G, p), x (G, n, p), y and mask (G, n) ->
loglik (C, G)[, grad (C, G, p)[, packed -Hessian (C, G, T)]]. The plain
versions are the references of :mod:`nestmc_torch.ops.loglik`.
"""

from __future__ import annotations

import torch

from nestmc_torch.ops import loglik as _plain
from nestmc_torch.ops.cuda import LAUNCHES, _build
from nestmc_torch.ops.cuda.common import (
    check_tensor,
    on_cpu,
    ptr,
    stream_of,
    tile_plan,
)

logistic_loglik_plain = _plain.logistic_loglik_padded
logistic_logp_grad_plain = _plain.logistic_logp_grad_padded
logistic_logp_grad_hess_plain = _plain.logistic_logp_grad_hess_padded


def _check(beta, x, y, mask, kind):
    """Check every operand and that the tile of ``kind`` (the kernel's
    launch mode, common.TILE_KINDS) fits."""
    C, G, p = beta.shape
    n = x.shape[1]
    for name, t, shape in (
        ("beta", beta, (C, G, p)), ("x", x, (G, n, p)),
        ("y", y, (G, n)), ("mask", mask, (G, n)),
    ):
        check_tensor(t, name, shape, beta.device)
    tile_plan(kind, n, p)


def _launch(lib, beta, x, y, mask, hess: bool, stream: int):
    C, G, p = beta.shape
    n = x.shape[1]
    dev = beta.device
    _check(beta, x, y, mask, "logp_grad_hess" if hess else "logp_grad")
    out_v = torch.empty((C, G), dtype=torch.float32, device=dev)
    out_g = torch.empty((C, G, p), dtype=torch.float32, device=dev)
    out_h = (
        torch.empty((C, G, p * (p + 1) // 2), dtype=torch.float32,
                    device=dev)
        if hess else None
    )
    rc = lib.nestmc_logp_grad(
        ptr(x), ptr(y), ptr(mask), ptr(beta), ptr(out_v), ptr(out_g),
        ptr(out_h), C, G, n, stream,
    )
    _build.check(rc, "logp_grad_hess" if hess else "logp_grad")
    return (out_v, out_g, out_h) if hess else (out_v, out_g)


def logistic_loglik(beta, x, y, mask):
    """(C, G) value-only loglik: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if on_cpu(beta, "loglik"):
        return logistic_loglik_plain(beta, x, y, mask)
    lib = _build.library(beta.shape[-1])
    C, G, _ = beta.shape
    with torch.cuda.device(beta.device):
        _check(beta, x, y, mask, "loglik")
        out = torch.empty((C, G), dtype=torch.float32, device=beta.device)
        rc = lib.nestmc_loglik(ptr(x), ptr(y), ptr(mask), ptr(beta),
                               ptr(out), C, G, x.shape[1], stream_of(beta))
    _build.check(rc, "loglik")
    LAUNCHES["loglik"] += 1
    return out


def logistic_logp_grad(beta, x, y, mask):
    """((C, G) loglik, (C, G, p) grad): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if on_cpu(beta, "logp_grad"):
        return logistic_logp_grad_plain(beta, x, y, mask)
    lib = _build.library(beta.shape[-1])
    with torch.cuda.device(beta.device):
        out = _launch(lib, beta, x, y, mask, False, stream_of(beta))
    LAUNCHES["logp_grad"] += 1
    return out


def logistic_logp_grad_hess(beta, x, y, mask):
    """((C, G) loglik, (C, G, p) grad, (C, G, T) packed -Hessian): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(beta, "logp_grad_hess"):
        return logistic_logp_grad_hess_plain(beta, x, y, mask)
    lib = _build.library(beta.shape[-1])
    with torch.cuda.device(beta.device):
        out = _launch(lib, beta, x, y, mask, True, stream_of(beta))
    LAUNCHES["logp_grad_hess"] += 1
    return out
