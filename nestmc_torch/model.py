"""Model abstraction: parameter blocks + the hooks the sampler calls.

Port of :mod:`nestmc.model` reduced to the fields the RW-MH, MALA and
Newton-MH paths, the draw collection and the calibration tiers (Geweke,
exactness) read.
A block with ``units = U > 0`` declares that its leading axis indexes U
conditionally independent units (groups) given the rest of the state: its
MH accept/reject is made per unit, for all units and all chains at once.
Every state leaf carries a leading chains axis. The built-in models are
written chain-batched; a model written for one chain is lifted to that
convention by :func:`vmap_chains`.

Hooks take an ``rng`` (nestmc_torch.rng.SweepRNG, or any object with the
same methods) where the reference takes a JAX key.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Block:
    """One Gibbs block (see nestmc.model.Block)."""

    name: str
    shape: tuple
    units: int = 0
    init_scale: float = 1.0
    target_accept: float | None = None
    algorithm: str | None = None
    repeats: int = 1

    @property
    def unit_shape(self) -> tuple:
        return self.shape[1:] if self.units else self.shape

    @property
    def unit_dim(self) -> int:
        d = 1
        for s in self.unit_shape:
            d *= int(s)
        return d


@dataclass(frozen=True)
class ModelSpec:
    """Declarative model.

    init_state(rng, data, chains) -> {name: (C, *shape)}.
    cond_logdensity(name, value, state, data) -> (C, U) or (C,): every term
      of the joint that involves block ``name``, at ``value``.
    joint_logdensity(state, data) -> (C,): the full joint log density.
    prior_sample(rng, data, chains) -> {name: (C, *shape)}: an exact draw
      from the prior (Geweke / SBC); optional.
    sample_data(rng, state, data) -> data: responses simulated given chain
      0's parameters, in the form of ``data``; optional.
    derived: {name: fn(position) -> (C, ...)}: deterministic quantities
      computed from the state when draws are collected (e.g. the centred
      theta = mu + tau z of a non-centred model), collectable by name.
    cond_value_and_grad(name, value, state, data) -> (value, grad) of the
      same in closed form, or None (kernels/mala.py then differentiates
      cond_logdensity with torch.autograd).
    cond_cached: {block: (self_fn, rest_fn)} for RW-MH: self_fn(value, data)
      -> (C, U) the part that depends on no other block (carried across
      sweeps), rest_fn(value, state, data) -> the rest.
    cond_cached_grad: {block: (self_vag, rest_vag)}, the same for MALA with
      (value, grad) pairs.
    gibbs_draws: {block: fn(rng, state, data) -> new value}, exact
      conditional draws (acceptance 1).
    joint_moves: {move: fn(rng, position, cache, scale, data, frozen=False)
      -> (position updates, cache updates, alpha (C,))}, run after the
      blocks every sweep.
    cond_cached_newton: {block: (self_vgh, rest_vgh)}: self_vgh(value,
      data) -> ((C, U) loglik, grad, (C, U, T) packed -Hessian) of the part
      that depends on no other block; rest_vgh(value, state, data) -> the
      same for the rest (broadcastable).
    fused_updates, fused_updates_mala: {block: fn(rng, position, cache,
      log_scale, data[, rhat_fold=None]) -> (value, cache, alpha[, fold])},
      one-kernel RW-MH and MALA updates.
    fused_updates_newton: {block: fn(rng, position, cache, log_scale, data,
      frozen=False, rhat_fold=None) -> (value, cache, alpha[, fold])}.
    loglik_impls: {'selected': name} of the obs-pass route the model chose,
      or any named implementations a user adds (:meth:`with_loglik_impl`).
    unit_axes: {block or derived name: 'groups' | 'subjects'}: the data
      axis that the value's dim 1 indexes. A group-sharded run splits
      these (parallel/sharding.py); a model declares them only when every
      sum over those units in its hooks goes through
      parallel.collectives.groups_sum, and a model without them is not
      group-sharded.
    """

    name: str
    blocks: tuple
    init_state: Callable
    cond_logdensity: Callable | None = None
    cond_value_and_grad: Callable | None = None
    joint_logdensity: Callable | None = None
    prior_sample: Callable | None = None
    sample_data: Callable | None = None
    derived: dict = dataclasses.field(default_factory=dict)
    cond_cached: dict = dataclasses.field(default_factory=dict)
    cond_cached_grad: dict = dataclasses.field(default_factory=dict)
    gibbs_draws: dict = dataclasses.field(default_factory=dict)
    joint_moves: dict = dataclasses.field(default_factory=dict)
    joint_move_repeats: dict = dataclasses.field(default_factory=dict)
    joint_move_init_scale: dict = dataclasses.field(default_factory=dict)
    joint_move_init_scale_grad: dict = dataclasses.field(
        default_factory=dict
    )
    joint_move_target_accept: dict = dataclasses.field(default_factory=dict)
    fused_updates: dict = dataclasses.field(default_factory=dict)
    fused_updates_mala: dict = dataclasses.field(default_factory=dict)
    fused_updates_newton: dict = dataclasses.field(default_factory=dict)
    cond_cached_newton: dict = dataclasses.field(default_factory=dict)
    loglik_impls: dict = dataclasses.field(default_factory=dict)
    unit_axes: dict = dataclasses.field(default_factory=dict)

    def block(self, name: str) -> Block:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(name)

    def with_loglik_impl(self, **impls) -> "ModelSpec":
        """This spec with ``impls`` merged into loglik_impls."""
        return dataclasses.replace(
            self, loglik_impls={**self.loglik_impls, **impls}
        )


_VMAP_RULES = (
    "a hook lifted by vmap_chains runs under torch.func.vmap, so it must "
    "not call .item(), float() or int() on a tensor, branch in Python on "
    "a tensor's value, or change a tensor it captured in place"
)


def _under_vmap(fn, args, what):
    try:
        return torch.func.vmap(fn)(*args)
    except RuntimeError as err:
        raise RuntimeError(f"vmap_chains: {what} failed under "
                           f"torch.func.vmap ({err}); {_VMAP_RULES}") from err


def _stack_chains(states):
    """[{name: (*shape)}] one a chain -> {name: (C, *shape)}."""
    return {k: torch.stack([torch.as_tensor(s[k]) for s in states])
            for k in states[0]}


def vmap_chains(spec: ModelSpec) -> ModelSpec:
    """Lift a ModelSpec written for UNBATCHED state (no chain axis) to the
    chain-batched convention (port of :func:`nestmc.model.vmap_chains`).

    cond_logdensity and joint_logdensity run under ``torch.func.vmap``
    over the chain axis of ``value`` and of every leaf of ``state``;
    ``data`` is not mapped. A scalar block's lifted cond returns (C,), a
    block of U units (C, U). The hooks must therefore be vmap-safe: no
    ``.item()``, ``float()`` or ``int()`` of a tensor, no Python ``if`` on
    a tensor's value (use ``torch.where``), no in-place change of a
    captured tensor; a hook that breaks one of these raises a
    RuntimeError that says so. torch.autograd differentiates through the
    lifted cond (the generic MALA path).

    init_state and prior_sample take the port's ``rng`` (a SweepRNG), not
    a key to split: the lifted hook calls the unbatched one once a chain,
    with ``chains=0`` as the reference passes, and stacks the results, so
    chain c gets the c-th draws. The other hooks (cond_value_and_grad, the
    cached splits, the fused updates) are left as they are, as the
    reference leaves them.
    """

    def cond(name, value, state, data):
        return _under_vmap(
            lambda v, s: spec.cond_logdensity(name, v, s, data),
            (value, state), f"cond_logdensity({name!r})")

    def joint(state, data):
        return _under_vmap(lambda s: spec.joint_logdensity(s, data),
                           (state,), "joint_logdensity")

    def init_state(rng, data, chains):
        return _stack_chains([spec.init_state(rng, data, 0)
                              for _ in range(chains)])

    prior = None
    if spec.prior_sample is not None:
        def prior(rng, data, chains):
            return _stack_chains([spec.prior_sample(rng, data, 0)
                                  for _ in range(chains)])

    return dataclasses.replace(
        spec,
        cond_logdensity=None if spec.cond_logdensity is None else cond,
        joint_logdensity=None if spec.joint_logdensity is None else joint,
        init_state=init_state,
        prior_sample=prior,
        # its sums over units are the user's own: never group-sharded
        unit_axes={},
    )


def state_dtype(state: dict) -> torch.dtype:
    """The promoted dtype of every tensor leaf of a (nested) state dict."""

    def leaves(obj):
        if isinstance(obj, dict):
            for v in obj.values():
                yield from leaves(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                yield from leaves(v)
        else:
            yield torch.as_tensor(obj).dtype

    return functools.reduce(torch.promote_types, leaves(state))
