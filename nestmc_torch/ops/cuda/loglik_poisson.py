"""Masked Poisson-log obs passes on the card (csrc/loglik_poisson.cu).

Port of nestmc/ops/pallas/loglik_poisson.py::poisson_loglik_padded_pallas,
::poisson_logp_grad_pallas and ::poisson_logp_grad_hess_pallas, with the
same public layouts: beta (C, S, p), x (S, n, p), y and mask (S, n) ->
loglik (C, S)[, grad (C, S, p)[, packed -Hessian (C, S, T)]]. The loglik
includes -const_s, the per-subject sum of mask * lgamma(y + 1): pass
``const`` (S,) to skip recomputing it (the model computes it once). The
plain versions are the references of :mod:`nestmc_torch.ops.loglik`.
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

poisson_loglik_plain = _plain.poisson_loglik_padded
poisson_logp_grad_plain = _plain.poisson_logp_grad_padded
poisson_logp_grad_hess_plain = _plain.poisson_logp_grad_hess_padded


def _checked(beta, x, y, mask, const, kind):
    """const (S,) on beta's device, after checking every operand and that
    the tile of ``kind`` (the kernel's launch mode, common.TILE_KINDS)
    fits."""
    C, S, p = beta.shape
    n = x.shape[1]
    if const is None:
        const = _plain.poisson_const(y, mask)
    for name, t, shape in (
        ("beta", beta, (C, S, p)), ("x", x, (S, n, p)), ("y", y, (S, n)),
        ("mask", mask, (S, n)), ("const", const, (S,)),
    ):
        check_tensor(t, name, shape, beta.device)
    tile_plan(kind, n, p)
    return const


def _launch_grad(beta, x, y, mask, const, hess: bool):
    lib = _build.library(beta.shape[-1])
    C, S, p = beta.shape
    dev = beta.device
    with torch.cuda.device(dev):
        const = _checked(beta, x, y, mask, const,
                         "logp_grad_hess" if hess else "logp_grad")
        out_v = torch.empty((C, S), dtype=torch.float32, device=dev)
        out_g = torch.empty((C, S, p), dtype=torch.float32, device=dev)
        out_h = (torch.empty((C, S, p * (p + 1) // 2), dtype=torch.float32,
                             device=dev) if hess else None)
        rc = lib.nestmc_pois_logp_grad(
            ptr(x), ptr(y), ptr(mask), ptr(const), ptr(beta), ptr(out_v),
            ptr(out_g), ptr(out_h), C, S, x.shape[1], stream_of(beta),
        )
    name = "pois_logp_grad_hess" if hess else "pois_logp_grad"
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return (out_v, out_g, out_h) if hess else (out_v, out_g)


def poisson_loglik(beta, x, y, mask, const=None):
    """(C, S) loglik: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if on_cpu(beta, "pois_loglik"):
        return poisson_loglik_plain(beta, x, y, mask, const)
    lib = _build.library(beta.shape[-1])
    C, S, _ = beta.shape
    with torch.cuda.device(beta.device):
        const = _checked(beta, x, y, mask, const, "loglik")
        out = torch.empty((C, S), dtype=torch.float32, device=beta.device)
        rc = lib.nestmc_pois_loglik(ptr(x), ptr(y), ptr(mask), ptr(const),
                                    ptr(beta), ptr(out), C, S, x.shape[1],
                                    stream_of(beta))
    _build.check(rc, "pois_loglik")
    LAUNCHES["pois_loglik"] += 1
    return out


def poisson_logp_grad(beta, x, y, mask, const=None):
    """((C, S) loglik, (C, S, p) grad): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if on_cpu(beta, "pois_logp_grad"):
        return poisson_logp_grad_plain(beta, x, y, mask, const)
    return _launch_grad(beta, x, y, mask, const, False)


def poisson_logp_grad_hess(beta, x, y, mask, const=None):
    """((C, S) loglik, (C, S, p) grad, (C, S, T) packed -Hessian): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(beta, "pois_logp_grad_hess"):
        return poisson_logp_grad_hess_plain(beta, x, y, mask, const)
    return _launch_grad(beta, x, y, mask, const, True)
