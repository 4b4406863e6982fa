"""The (chains, groups) mesh of a multi-process run and its split rules.

Port of :mod:`nestmc.parallel.sharding` onto torch.distributed, one
process a rank (multihost.initialize). Rank r holds chain shard r //
group_shards and group shard r % group_shards:

- chains (data parallel): each rank runs its chains; nothing crosses
  ranks in the hot loop, and the draws are bitwise the unsharded run's
  (rng.py draws every tensor at its global shape).
- groups (model parallel): each rank runs its groups' units; every sum
  over units in a population conditional or a joint move is an
  all_reduce over the ranks of its chain shard
  (collectives.groups_sum).

Every rank holds the full data (it has no chain axis) and only its part
of every tensor with a chain or unit axis: :func:`shard_state` draws the
initial positions at their global shapes (the seed's bits), cuts them at
once and builds the rest of the carry (scales, acceptance sums,
preconditioner moments, caches) from the cut positions on the shard's
local data, as the reference places each device's part on the mesh. A
given global carry (a resumed run's) is cut (:func:`take`;
:func:`shard_inputs` cuts a carry and the data together). A
spec is a tuple of axis names, one a leading dim ('chains', 'groups',
'subjects' or None), like the reference's PartitionSpec; an axis is split
into contiguous near-equal ranges.

What is split: the chains axis of every state leaf; under group
sharding, the unit axis (dim 1) of every block and derived quantity the
model names in ``ModelSpec.unit_axes`` (with its scales, acceptance sums,
caches and preconditioner moments), padded NestedData's group axis,
NestedData3's subjects with whole groups on each shard (subject_group is
sorted) and its groups, and RaggedData's groups with their observation
rows (segment_ids are sorted, so a shard's rows are one contiguous run:
the 'obs' span; RaggedData.subset_groups). A model group-shards when it
declares unit axes: the built-in models route every sum over units
through groups_sum, and a vmap_chains lift gathers the unit axis and runs
the user's hooks at full width (model.py). A model that declares none
raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from nestmc_torch.config import SamplerConfig
from nestmc_torch.data import NestedData, NestedData3, RaggedData
from nestmc_torch.parallel.collectives import Shard, activate, gather
from nestmc_torch.parallel.multihost import world_size


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (chain_shards, group_shards) mesh.

    chains_group: the process group of the ranks of this rank's group
    shard (they hold the other chains of the same units); groups_group:
    the ranks of this rank's chain shard (the reduction over groups).
    Each is None when its axis is not split.
    """

    chain_shards: int
    group_shards: int
    rank: int
    chains_group: object = None
    groups_group: object = None

    @property
    def chain_index(self) -> int:
        return self.rank // self.group_shards

    @property
    def group_index(self) -> int:
        return self.rank % self.group_shards


_GROUPS: dict = {}


def make_mesh(cfg: SamplerConfig) -> Mesh | None:
    """The mesh of cfg.sharding, or None for (1, 1). Its size must be the
    process group's: one rank (device) a shard."""
    cs, gs = cfg.sharding.chain_shards, cfg.sharding.group_shards
    n = cs * gs
    if n == 1:
        return None
    world = world_size()
    if world != n:
        raise ValueError(
            f"sharding needs {n} devices ({cs} chain x {gs} group shards, "
            f"one process each), have {world}: launch {n} processes "
            "(parallel.multihost.initialize)")
    key = (cs, gs)
    if key not in _GROUPS:
        # every rank creates every group, in the same order
        chains = [dist.new_group([i * gs + j for i in range(cs)])
                  for j in range(gs)] if cs > 1 else [None] * gs
        groups = [dist.new_group([i * gs + j for j in range(gs)])
                  for i in range(cs)] if gs > 1 else [None] * cs
        _GROUPS[key] = (chains, groups)
    chains, groups = _GROUPS[key]
    r = dist.get_rank()
    return Mesh(cs, gs, r, chains[r % gs], groups[r // gs])


def _span(total: int, parts: int, i: int) -> tuple:
    start, stop = (i * total) // parts, ((i + 1) * total) // parts
    return start, stop - start, total


def _check_groupable(model, data) -> None:
    if not model.unit_axes:
        raise ValueError(
            f"group sharding: model {model.name!r} does not route its sums "
            "over units through parallel.collectives.groups_sum; shard "
            "chains instead")
    if not isinstance(data, (NestedData, NestedData3, RaggedData)):
        raise ValueError(
            f"group sharding: {type(data).__name__} data have no group "
            "axis to split; shard chains instead")


def shard_spans(model, data, cfg: SamplerConfig, mesh: Mesh) -> dict:
    """{axis: (start, length, total)} of this rank's part of the run."""
    if mesh.group_shards > 1:
        _check_groupable(model, data)
    return _spans_at(data, cfg, mesh, mesh.chain_index, mesh.group_index)


def _spans_at(data, cfg: SamplerConfig, mesh: Mesh, ci: int, gi: int):
    """shard_spans of the shard at chain index ci, group index gi."""
    spans = {"chains": _span(cfg.run.chains, mesh.chain_shards, ci)}
    if mesh.group_shards == 1:
        return spans
    spans["groups"] = _span(data.num_groups, mesh.group_shards, gi)
    g0, gl, _ = spans["groups"]
    if isinstance(data, NestedData3):
        s0, s1 = np.searchsorted(data.subject_group.cpu().numpy(),
                                 [g0, g0 + gl])
        spans["subjects"] = (int(s0), int(s1 - s0), data.num_subjects)
    if isinstance(data, RaggedData):
        r0, r1 = (int(r) for r in data.offsets[[g0, g0 + gl]].cpu())
        spans["obs"] = (r0, r1 - r0, data.num_obs)
    return spans


def _unit_spec(model, cfg: SamplerConfig, name: str) -> tuple:
    axis = (model.unit_axes.get(name)
            if cfg.sharding.group_shards > 1 else None)
    return ("chains", axis) if axis else ("chains",)


def state_shardings(model, cfg: SamplerConfig, mesh: Mesh | None):
    """A KernelState of specs for this model and config. A cache entry's
    spec covers every tensor of the entry; precond maps each moment."""
    from nestmc_torch.kernels.state import KernelState

    if mesh is None:
        return None
    position, log_scale, accept_sum, cache, precond = {}, {}, {}, {}, {}
    for b in model.blocks:
        spec = _unit_spec(model, cfg, b.name)
        position[b.name] = accept_sum[b.name] = cache[b.name] = spec
        per_unit = cfg.kernel.scale_per_unit and b.units > 0
        log_scale[b.name] = spec if per_unit else ("chains",)
        precond[b.name] = {"mean": spec, "var": spec, "cov": spec,
                           "count": ("chains",)}
    for mname in model.joint_moves:
        log_scale[mname] = accept_sum[mname] = ("chains",)
    return KernelState(position=position, log_scale=log_scale,
                       accept_sum=accept_sum, cache=cache, t=(),
                       precond=precond)


def data_shardings(data, cfg: SamplerConfig, mesh: Mesh | None):
    """{field: spec} of the data container: padded NestedData split on
    the group axis, NestedData3 on subjects (subject_counts on groups)
    and RaggedData on its observation rows (the 'obs' span; offsets on
    groups) under group sharding; everything else replicated (()).
    NestedData3's members and RaggedData's ids and offsets are rebuilt
    for the shard (rebased to its first group), not only split."""
    if mesh is None:
        return None
    grouped = cfg.sharding.group_shards > 1
    if isinstance(data, NestedData):
        g = ("groups",) if grouped else ()
        return {"y": g, "mask": g, "sizes": g, "x": g, "extra": {
            k: g if v.shape[:1] == (data.num_groups,) else ()
            for k, v in data.extra.items()}}
    if isinstance(data, NestedData3):
        s, g = (("subjects",), ("groups",)) if grouped else ((), ())
        return {"y": s, "mask": s, "x": s, "subject_group": s,
                "subject_counts": g, "extra": {
                    k: s if v.shape[:1] == (data.num_subjects,) else ()
                    for k, v in data.extra.items()}}
    if isinstance(data, RaggedData):
        o, g = (("obs",), ("groups",)) if grouped else ((), ())
        axes = {"obs": o, "groups": g, None: ()}
        return {"y": o, "x": o, "segment_ids": o, "offsets": g, "extra": {
            k: axes[data.extra_axis(v)] for k, v in data.extra.items()}}
    return {}


def map_specs(fn, spec, tree):
    """fn(tensor, spec) over a tree of tensors (dicts, tuples, lists, a
    KernelState), the spec tree alongside; a tuple spec covers a subtree,
    a dict spec is followed key by key."""
    from nestmc_torch.kernels.state import KernelState

    if tree is None:
        return None
    if isinstance(tree, KernelState):
        return KernelState(**{
            f.name: (getattr(tree, f.name) if f.name == "t" else
                     map_specs(fn, getattr(spec, f.name),
                               getattr(tree, f.name)))
            for f in dataclasses.fields(KernelState)})
    if isinstance(tree, dict):
        return {k: map_specs(fn, spec[k] if isinstance(spec, dict)
                             else spec, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, spec, v) for v in tree)
    if torch.is_tensor(tree):
        return fn(tree, spec)
    return tree


def take(t, spec, spans: dict):
    """This rank's part of ``t``: the global tensor cut, or ``t`` itself
    when it already is this rank's part (its extent along every split
    axis the rank's span, as in a rank part a sharded run returned on the
    same mesh); any other extent raises."""
    for dim, axis in enumerate(spec):
        span = spans.get(axis)
        if span is None or span[1] == span[2] or dim >= t.ndim:
            continue
        if t.shape[dim] == span[2]:
            t = t.narrow(dim, span[0], span[1])
        elif t.shape[dim] != span[1]:
            raise ValueError(
                f"a tensor of extent {t.shape[dim]} along {axis!r} is "
                f"neither the global one ({span[2]}) nor this rank's "
                f"part ({span[1]})")
    return t.contiguous()


def _local_data(data, cfg: SamplerConfig, mesh: Mesh, spans: dict):
    if mesh.group_shards == 1:
        return data
    specs = data_shardings(data, cfg, mesh)

    def cut(t, spec):
        return take(t, spec, spans)

    if isinstance(data, NestedData):
        return NestedData(
            y=cut(data.y, specs["y"]), mask=cut(data.mask, specs["mask"]),
            sizes=cut(data.sizes, specs["sizes"]),
            x=cut(data.x, specs["x"]),
            extra=map_specs(cut, specs["extra"], data.extra))
    g0, gl, _ = spans["groups"]
    return data.subset_groups(g0, g0 + gl)


def shard_inputs(state, data, model, cfg: SamplerConfig, mesh: Mesh | None):
    """(this rank's part of the global carry ``state``, its data). Every
    rank passes the same full inputs, built from the same seed."""
    if mesh is None:
        return state, data
    shard = make_shard(model, data, cfg, mesh)
    return (map_specs(lambda t, s: take(t, s, shard.spans),
                      state_shardings(model, cfg, mesh), state),
            shard.local)


def shard_state(model, cfg: SamplerConfig, rng, shard: Shard):
    """This rank's part of ``init_kernel_state(model, cfg, rng,
    shard.data)``, built without the global carry: the positions are drawn
    at their global shapes and cut at once (the only global tensors, and
    only until the cut), and every other leaf is built from the cut
    positions on the shard's local data, the cache hooks running with the
    shard active as the sweep runs them (the kernels at the shard's
    offsets). Every such leaf is per (chain, unit), so the part is the cut
    of the global carry bit for bit."""
    from nestmc_torch.kernels.state import init_kernel_state

    specs = state_shardings(model, cfg, shard.mesh).position
    position = {k: take(v, specs[k], shard.spans) for k, v in
                model.init_state(rng, shard.data, cfg.run.chains).items()}
    with activate(shard):
        return init_kernel_state(model, cfg, rng, shard.local,
                                 position=position)


def make_shard(model, data, cfg: SamplerConfig, mesh: Mesh) -> Shard:
    """This rank's collectives.Shard of a run on the full ``data``."""
    spans = shard_spans(model, data, cfg, mesh)
    parts = {"chains": tuple(_span(cfg.run.chains, mesh.chain_shards, i)[:2]
                             for i in range(mesh.chain_shards))}
    by_group = [_spans_at(data, cfg, mesh, mesh.chain_index, j)
                for j in range(mesh.group_shards)]
    parts.update({axis: tuple(sp[axis][:2] for sp in by_group)
                  for axis in spans if axis != "chains"})
    return Shard(mesh=mesh, spans=spans, parts=parts, data=data,
                 local=_local_data(data, cfg, mesh, spans))


@dataclass(frozen=True)
class Placement:
    """Where a sharded run's rank parts sit (Posterior.placement): the
    rank's collectives.Shard and the run's state_shardings."""

    shard: Shard
    specs: object


def gather_state(post):
    """The global layout of ``post.final_state``, on every rank of a
    sharded run (a collective: every rank calls it); the state itself for
    an unsharded run. A sharded run's Posterior holds only the rank's part
    of its final carry, as the reference's holds a sharded array."""
    pl = getattr(post, "placement", None)
    if pl is None:
        return post.final_state
    return map_specs(lambda t, sp: gather(t, sp, pl.shard), pl.specs,
                     post.final_state)


def gather_rates(post) -> tuple:
    """(accept_rates, warmup_accept_rates) of ``post`` in the global
    layout, on every rank of a sharded run (a collective, as
    :func:`gather_state`); the Posterior's own dicts unsharded."""
    pl = getattr(post, "placement", None)
    if pl is None:
        return post.accept_rates, getattr(post, "warmup_accept_rates", None)
    return tuple({k: gather(v, pl.specs.accept_sum[k], pl.shard)
                  for k, v in rates.items()}
                 for rates in (post.accept_rates, post.warmup_accept_rates))
