"""The collectives of a sharded run, and the shard it runs on.

PyTorch inserts no collective by itself: every sum over the unit axis of
a group-sharded block goes through :func:`groups_sum`, and the engine
gathers what a run returns (draws, accumulators, the final carry) with
:func:`gather`. Both use only ``all_reduce``, which NCCL and gloo (also on
CUDA tensors) both serve.

:func:`activate` makes a :class:`Shard` the one these functions read
while a sharded ``sample`` runs; with none active (every unsharded run)
:func:`groups_sum` is a plain sum and the models' shard helpers return
what they are given.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

# calls and host seconds of the reductions over groups (seconds are
# measured only with TIMING on: each call then synchronises the device)
STATS = {"groups_sum_calls": 0, "groups_sum_s": 0.0}
TIMING = False

_ACTIVE = None


@dataclass(frozen=True)
class Shard:
    """One rank's part of a run.

    mesh: the parallel.sharding.Mesh. spans: {axis: (start, length,
    total)} for 'chains' and, under group sharding, 'groups' (and
    'subjects' for three-level data): this rank holds entries start..
    start+length of the axis's total. data: the full data the shard was
    cut from; local: this rank's data.
    """

    mesh: object
    spans: dict
    data: object
    local: object

    def split(self, axis) -> bool:
        span = self.spans.get(axis)
        return span is not None and span[1] != span[2]


@contextlib.contextmanager
def activate(shard):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard
    try:
        yield shard
    finally:
        _ACTIVE = prev


def _sync(x) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _all_reduce_groups(t, group):
    STATS["groups_sum_calls"] += 1
    if TIMING:
        _sync(t)
        t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    if TIMING:
        _sync(t)
        STATS["groups_sum_s"] += time.perf_counter() - t0
    return t


class _GroupsSum(torch.autograd.Function):
    """The all_reduce of a partial sum, for torch.autograd. A replicated
    parameter theta's gradient is g_rep (its terms every rank computes)
    plus the sum over ranks of g_r (its terms in rank r's partial). The
    backward scales the partial's gradient by the group shards, so rank r
    gets g_rep + shards * g_r, and :func:`groups_mean` of that over the
    ranks is the gradient."""

    @staticmethod
    def forward(ctx, partial, group, shards):
        ctx.shards = shards
        return _all_reduce_groups(partial.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.shards, None, None


def groups_sum(x, dim, keepdim: bool = False):
    """x.sum(dim) over the units of every group shard: the local sum,
    then an all_reduce(SUM) over the ranks that share this rank's chains
    (the identity on one group shard, so an unsharded run's bits are
    those of the plain sum). Every such rank gets the same bits.
    torch.autograd differentiates through it with :func:`groups_mean`
    (the generic MALA path, kernels/mala.py)."""
    out = x.sum(dim=dim, keepdim=keepdim)
    s = _ACTIVE
    if s is None or s.mesh.group_shards == 1:
        return out
    if out.requires_grad:
        return _GroupsSum.apply(out, s.mesh.groups_group,
                                s.mesh.group_shards)
    return _all_reduce_groups(out, s.mesh.groups_group)


def groups_mean(x):
    """The mean of ``x`` over the ranks of this rank's chain shard (the
    identity on one group shard): with groups_sum's backward, the
    autograd gradient of a replicated parameter (kernels/mala.py)."""
    s = _ACTIVE
    if s is None or s.mesh.group_shards == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=s.mesh.groups_group)
    return out / s.mesh.group_shards


def unit_span(axis: str):
    """(start, total) of this rank's units of data axis ``axis``
    ('groups' or 'subjects') when a group-sharded run splits it, else
    None: the ``units`` argument of the step wrappers."""
    s = _ACTIVE
    if s is None or not s.split(axis):
        return None
    start, _, total = s.spans[axis]
    return start, total


def unit_draw(axis: str | None, dim: int = 1):
    """The ``units`` argument of an rng draw whose tensor's ``dim`` is
    the unit axis of data axis ``axis`` (None: no unit axis)."""
    span = None if axis is None else unit_span(axis)
    return None if span is None else (dim, *span)


def local_units(t, dim: int, axis: str = "groups"):
    """This rank's units of ``t`` along ``dim`` (a tensor a model built
    from the full data, e.g. a per-group constant); ``t`` unsharded."""
    s = _ACTIVE
    if s is None or not s.split(axis):
        return t
    start, length, _ = s.spans[axis]
    return t.narrow(dim, start, length)


def local_data(data):
    """The active shard's local data when ``data`` is the full data it
    was cut from (a model's build-time data), else ``data``."""
    s = _ACTIVE
    return s.local if s is not None and data is s.data else data


def gather(x, spec, shard=None):
    """The global tensor of which ``x`` is this rank's part, on every
    rank. spec: one entry a leading dim of x: None (not split), an axis
    name of the shard's spans, or (positions, total): x's entries along
    that dim are entries ``positions`` (a long tensor) of ``total``. The
    part goes into a zero-filled global buffer, summed over the ranks
    that hold the other parts (chains, units, or both)."""
    s = shard if shard is not None else _ACTIVE
    places, kinds = [], set()
    for dim, item in enumerate(spec):
        if item is None:
            continue
        if isinstance(item, str):
            if not s.split(item):
                continue
            start, _, total = s.spans[item]
            places.append((dim, start, total))
            kinds.add("chains" if item == "chains" else "units")
        else:
            positions, total = item
            places.append((dim, positions, total))
            kinds.add("units")
    if not places:
        return x
    out = x
    for dim, where, total in places:
        shape = list(out.shape)
        shape[dim] = total
        buf = out.new_zeros(shape)
        if isinstance(where, int):
            buf.narrow(dim, where, out.shape[dim]).copy_(out)
        else:
            buf.index_copy_(dim, where.to(out.device), out)
        out = buf
    mesh = s.mesh
    if kinds == {"chains"}:
        group = mesh.chains_group
    elif kinds == {"units"}:
        group = mesh.groups_group
    else:
        group = None                                    # every rank
    dist.all_reduce(out, group=group)
    return out


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on some rank."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
