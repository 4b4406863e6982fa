"""The sampler carry: positions + scales + acceptance bookkeeping + caches.

Port of :mod:`nestmc.kernels.state` for the Newton-MH path. The RNG is not
part of the state (the run's nestmc_torch.rng.SweepRNG is passed
alongside), and there is no preconditioner state (precond='none' only).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from nestmc_torch.config import SamplerConfig
from nestmc_torch.model import ModelSpec


@dataclass
class KernelState:
    """Chain-batched sampler state (every tensor leads with the chains axis).

    position:   {name: (C, *shape)} current values.
    log_scale:  {name: (C, U)} log proposal scales (log sqrt(c) for Newton).
    accept_sum: {name: (C, U)} summed acceptance probabilities.
    cache:      {name: None | {'v', 'g', 'h'}} carried likelihood value,
                gradient and packed -Hessian at the current position.
    t:          sweeps taken.
    """

    position: dict
    log_scale: dict
    accept_sum: dict
    cache: dict
    t: int = 0


def scale_units(block, cfg: SamplerConfig) -> int:
    if block.units and cfg.kernel.scale_per_unit:
        return block.units
    return 1


def _algorithm(block, model, cfg) -> str:
    algorithm = block.algorithm or cfg.kernel.algorithm
    if algorithm == "newton" and block.name not in model.cond_cached_newton:
        algorithm = "mala"  # the reference's fallback (kernels/gibbs.py)
    return algorithm


def init_kernel_state(model: ModelSpec, cfg: SamplerConfig, rng, data,
                      position: dict | None = None) -> KernelState:
    """Build the initial carry on the data's device. ``position``
    overrides the model's init. Newton blocks get their cache from one
    grad+Hessian obs pass and log_scale 0 (c = 1, never adapted)."""
    chains = cfg.run.chains
    if position is None:
        position = model.init_state(rng, data, chains)
    dev = data.device
    log_scale, accept_sum, cache = {}, {}, {}
    for b in model.blocks:
        u = scale_units(b, cfg)
        s0 = b.init_scale * 2.38 / math.sqrt(max(b.unit_dim, 1))
        log_scale[b.name] = torch.full((chains, u), math.log(s0), device=dev)
        accept_sum[b.name] = torch.zeros((chains, max(b.units, 1)), device=dev)
        cache[b.name] = None
        if b.name in model.gibbs_draws:
            continue
        if _algorithm(b, model, cfg) != "newton":
            raise NotImplementedError(
                f"block {b.name!r}: only Newton-MH blocks are ported"
            )
        self_vgh, _ = model.cond_cached_newton[b.name]
        val, grad, hess = self_vgh(position[b.name], data)
        cache[b.name] = {"v": val, "g": grad, "h": hess}
        log_scale[b.name] = torch.zeros_like(log_scale[b.name])
    for mname in model.joint_moves:
        # Newton blocks carry a gradient cache, so the move runs
        # metric-preconditioned at its O(1) start scale
        s0 = model.joint_move_init_scale_grad.get(
            mname, model.joint_move_init_scale.get(mname, 0.1)
        )
        log_scale[mname] = torch.full((chains, 1), math.log(s0), device=dev)
        accept_sum[mname] = torch.zeros((chains, 1), device=dev)
    return KernelState(position, log_scale, accept_sum, cache, 0)


def state_from_numpy(position: dict, log_scale: dict, accept_sum: dict,
                     cache: dict, t: int = 0, device="cpu") -> KernelState:
    """A KernelState from numpy arrays (e.g. a JAX KernelState's leaves):
    ``cache`` maps block -> None or {'v', 'g', 'h'}."""

    def t_(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return KernelState(
        position={k: t_(v) for k, v in position.items()},
        log_scale={k: t_(v) for k, v in log_scale.items()},
        accept_sum={k: t_(v) for k, v in accept_sum.items()},
        cache={
            k: None if c is None else {kk: t_(vv) for kk, vv in c.items()}
            for k, c in cache.items()
        },
        t=int(t),
    )
