"""The sampler carry: positions + scales + acceptance bookkeeping + caches.

Port of :mod:`nestmc.kernels.state`. The RNG is not part of the state: the
run's nestmc_torch.rng.SweepRNG is passed alongside, and a checkpoint
carries its generators' states next to the KernelState (checkpoint.py,
:func:`checkpoint_template`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from nestmc_torch.adapt import init_precond
from nestmc_torch.config import SamplerConfig
from nestmc_torch.data import check_device, data_device
from nestmc_torch.model import ModelSpec
from nestmc_torch.parallel.collectives import local_count


@dataclass
class KernelState:
    """Chain-batched sampler state (every tensor leads with the chains axis).

    position:   {name: (C, *shape)} current values.
    log_scale:  {name: (C, U)} log proposal scales (log sqrt(c) for Newton).
    accept_sum: {name: (C, U)} summed acceptance probabilities.
    precond:    {name: None | {'mean', 'var' | 'cov', 'count'}} the
                block's preconditioner moments (adapt.init_precond; None
                under precond='none').
    cache:      {name: None | (C, U) | {'v', 'g'[, 'h']}} the carried self
                part of the block's conditional at the current position:
                its value (RW-MH), value and gradient (MALA), and the
                packed -Hessian too (Newton-MH).
    t:          sweeps taken.
    """

    position: dict
    log_scale: dict
    accept_sum: dict
    cache: dict
    t: int = 0
    precond: dict = field(default_factory=dict)


def scale_units(block, cfg: SamplerConfig) -> int:
    if block.units and cfg.kernel.scale_per_unit:
        return block.units
    return 1


def init_kernel_state(model: ModelSpec, cfg: SamplerConfig, rng, data,
                      position: dict | None = None) -> KernelState:
    """Build the initial carry on the position's device (the model's init
    draws it on the rng's). ``position`` overrides the model's init; the
    data are opaque here, passed only to the model's hooks. A block gets
    the cache its algorithm carries, from one obs pass: the self part's
    value (RW-MH), value and gradient (MALA), or value, gradient and
    Hessian (Newton-MH, whose log_scale is 0: c = 1, never adapted), and
    the preconditioner state of KernelConfig.precond.

    The carry takes its chains from ``position`` and, under an active
    group shard (parallel.collectives.activate), its units of every split
    unit axis from the shard: with this rank's part of the position and
    the shard's local data it is this rank's part of the carry
    (parallel.sharding.shard_state)."""
    from nestmc_torch.kernels.gibbs import block_algorithm, grad_cache_live

    if position is None:
        position = model.init_state(rng, data, cfg.run.chains)
    first = next(iter(position.values()))
    chains, dev = first.shape[0], first.device
    log_scale, accept_sum, cache, precond = {}, {}, {}, {}
    for b in model.blocks:
        units = local_count(model.unit_axes.get(b.name), b.units)
        u = units if scale_units(b, cfg) > 1 else 1
        s0 = b.init_scale * 2.38 / math.sqrt(max(b.unit_dim, 1))
        log_scale[b.name] = torch.full((chains, u), math.log(s0), device=dev)
        precond[b.name] = init_precond(position[b.name], cfg.kernel,
                                       unit_dim=b.unit_dim)
        accept_sum[b.name] = torch.zeros((chains, max(units, 1)),
                                         device=dev)
        cache[b.name] = None
        if b.name in model.gibbs_draws:
            continue
        algorithm = block_algorithm(b, model, cfg)
        value = position[b.name]
        if algorithm == "rwmh" and b.name in model.cond_cached:
            val = model.cond_cached[b.name][0](value, data)
            cache[b.name] = val if b.units else val[:, None]
        elif algorithm == "mala" and b.name in model.cond_cached_grad:
            val, grad = model.cond_cached_grad[b.name][0](value, data)
            cache[b.name] = {"v": val if b.units else val[:, None],
                             "g": grad}
        elif algorithm == "newton":
            val, grad, hess = model.cond_cached_newton[b.name][0](value, data)
            cache[b.name] = {"v": val, "g": grad, "h": hess}
            log_scale[b.name] = torch.zeros_like(log_scale[b.name])
    grad_live = grad_cache_live(model, cfg)
    for mname in model.joint_moves:
        # with a gradient cache the move runs metric-preconditioned and its
        # natural scale is O(1); the RW move starts at the model's guess
        if grad_live and mname in model.joint_move_init_scale_grad:
            s0 = model.joint_move_init_scale_grad[mname]
        else:
            s0 = model.joint_move_init_scale.get(mname, 0.1)
        log_scale[mname] = torch.full((chains, 1), math.log(s0), device=dev)
        accept_sum[mname] = torch.zeros((chains, 1), device=dev)
    return KernelState(position, log_scale, accept_sum, cache, 0, precond)


def checkpoint_template(model: ModelSpec, cfg: SamplerConfig, data,
                        with_acc: bool = False) -> dict:
    """The structure and shapes a checkpoint of this (model, config) must
    have, for checkpoint.load_checkpoint to validate against: {'state':
    a KernelState from init_kernel_state (one obs pass per cached block,
    as the reference's template costs), 'rng': SweepRNG.get_state() of a
    generator pair on the data's device}, plus 'acc': the engine's
    streamed R-hat accumulators (std_acc, fold_acc) when ``with_acc``
    (a sample-phase checkpoint of a full_rhat run)."""
    from nestmc_torch.diagnostics import fold_rhat_init, streaming_rhat_init
    from nestmc_torch.kernels.gibbs import rhat_fold_names
    from nestmc_torch.rng import SweepRNG

    rng = SweepRNG(cfg.run.seed, data_device(data))
    state = init_kernel_state(model, cfg, rng, data)
    out = {"state": state, "rng": rng.get_state()}
    if with_acc:
        folds = rhat_fold_names(model, cfg)
        out["acc"] = (
            streaming_rhat_init({k: v for k, v in state.position.items()
                                 if k not in folds}),
            fold_rhat_init(state.position, folds),
        )
    return out


def state_from_numpy(position: dict, log_scale: dict, accept_sum: dict,
                     cache: dict, t: int = 0, device="cuda") -> KernelState:
    """A KernelState from numpy arrays (e.g. a JAX KernelState's leaves),
    on ``device`` (the card unless the caller asks for another). ``cache``
    maps block -> None, a (C, U) array (RW-MH) or a dict of arrays (MALA
    {'v', 'g'}, Newton {'v', 'g', 'h'})."""
    device = check_device(device)

    def t_(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def cache_(c):
        if c is None:
            return None
        if isinstance(c, dict):
            return {k: t_(v) for k, v in c.items()}
        return t_(c)

    return KernelState(
        position={k: t_(v) for k, v in position.items()},
        log_scale={k: t_(v) for k, v in log_scale.items()},
        accept_sum={k: t_(v) for k, v in accept_sum.items()},
        cache={k: cache_(c) for k, c in cache.items()},
        t=int(t),
    )
