"""The collectives of a sharded run, and the shard it runs on.

PyTorch inserts no collective by itself: every sum over the unit axis of
a group-sharded block goes through :func:`groups_sum` (an ``all_reduce``),
a model whose sums over units it cannot split (a ``vmap_chains`` lift)
gathers the unit axis with :func:`groups_gather`, and the engine gathers
what a sharded run gathers for every rank (the collected draws, the
R-hat maps) with :func:`gather`. The last two use ``all_gather``; NCCL
and gloo (also on CUDA tensors) serve both. A checkpoint's carry goes to
the primary alone (:func:`gather_to_primary`, one ``gather``), and the
mean acceptance a Posterior reports is reduced where the rates live
(:func:`global_mean`).

:func:`activate` makes a :class:`Shard` the one these functions read
while a sharded ``sample`` runs; with none active (every unsharded run)
:func:`groups_sum` is a plain sum and the models' shard helpers return
what they are given.

Under a captured step (segments.py: a run on the card whose collectives
the backend can capture, NCCL) the all_reduces and all_gathers of
:func:`groups_sum`, :func:`groups_mean` and :func:`groups_gather` are
recorded into the CUDA graph and run at each replay, on the mesh's own
process groups (sharding.make_mesh), never on the default group that
the eager collectives between segments use (:func:`any_rank`,
:func:`lockstep`, :func:`gather_to_primary`). ``STATS``'s call counts
are host counts: segments.py adds a captured step's counts at each
replay, as it does the kernel launches. ``TIMING`` synchronises the
device around every reduction, which a capture cannot hold: set it only
for an eager run (``sample(..., _eager=True)``).
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
    'subjects' for three-level data, 'obs' for ragged data's observation
    rows): this rank holds entries start..
    start+length of the axis's total. parts: {axis: ((start, length),
    ...)} of every shard along the axis's side of the mesh (the chain
    shards for 'chains', the group shards for the rest), this rank's
    included. data: the full data the shard was cut from; local: this
    rank's data.
    """

    mesh: object
    spans: dict
    parts: dict
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


def _capturing(t) -> bool:
    """Whether ``t``'s stream is being captured into a CUDA graph."""
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _all_reduce_groups(t, group):
    STATS["groups_sum_calls"] += 1
    if TIMING:
        if _capturing(t):
            raise RuntimeError(
                "collectives.TIMING synchronises the device around each "
                "groups_sum, which a CUDA graph capture cannot hold: time "
                "the collectives in an eager run, sample(..., _eager=True)")
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
    those of the plain sum). Every such rank gets the same bits; they
    differ from the unsharded sum's in the last bits (float32 sums in
    another order), so a group-sharded run agrees with the unsharded
    one in distribution, not draw for draw. torch.autograd
    differentiates through it with :func:`groups_mean` (the generic MALA
    path, kernels/mala.py)."""
    out = x.sum(dim=dim, keepdim=keepdim)
    s = _ACTIVE
    if s is not None and s.mesh.group_shards > 1 and out.requires_grad:
        return _GroupsSum.apply(out, s.mesh.groups_group,
                                s.mesh.group_shards)
    return groups_total(out)


def groups_total(partial):
    """The sum over the group shards of ``partial``, a sum this rank took
    over its own units (a kernel's per-chain row): one all_reduce(SUM), in
    place, over the ranks that share this rank's chains, as in
    :func:`groups_sum`; the identity on one group shard."""
    s = _ACTIVE
    if s is None or s.mesh.group_shards == 1:
        return partial
    return _all_reduce_groups(partial, s.mesh.groups_group)


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


def active():
    """The Shard of the sharded run in progress, or None."""
    return _ACTIVE


def full_data(data):
    """The full data the active shard was cut from when ``data`` is that
    shard's local data, else ``data`` (the inverse of :func:`local_data`)."""
    s = _ACTIVE
    return s.data if s is not None and data is s.local else data


def _all_gather_padded(x, dims, lengths, group):
    """[each rank's part] of ``group``: rank r's part has length
    lengths[r][i] along dims[i]. all_gather needs equal sizes, so every
    part is padded to the longest along each of ``dims`` and trimmed
    back."""
    part = x
    for i, dim in enumerate(dims):
        longest = max(r[i] for r in lengths)
        if part.shape[dim] < longest:
            pad = list(part.shape)
            pad[dim] = longest - part.shape[dim]
            part = torch.cat([part, part.new_zeros(pad)], dim=dim)
    part = part.contiguous()
    parts = [torch.empty_like(part) for _ in lengths]
    dist.all_gather(parts, part, group=group)
    out = []
    for q, lens in zip(parts, lengths):
        for dim, n in zip(dims, lens):
            q = q.narrow(dim, 0, n)
        out.append(q)
    return out


class _GroupsGather(torch.autograd.Function):
    """The all_gather of a group-sharded unit axis; its backward hands
    each rank its own units' slice of the gradient (every rank computes
    the gradient of its own outputs, which depend only on them)."""

    @staticmethod
    def forward(ctx, x, dim, group, spans, index):
        ctx.dim, ctx.span = dim, spans[index]
        return torch.cat(_all_gather_padded(
            x, (dim,), [(n,) for _, n in spans], group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start, length = ctx.span
        return grad.narrow(ctx.dim, start, length), None, None, None, None


def groups_gather(x, dim: int):
    """The full group axis of ``x``, whose ``dim`` holds this rank's
    groups of a group-sharded run, on every rank of its chain shard
    (``x`` itself with no split). torch.autograd differentiates through
    it: the gradient of ``x`` is this rank's slice of the gathered one's."""
    s = _ACTIVE
    if s is None or not s.split("groups"):
        return x
    mesh = s.mesh
    return _GroupsGather.apply(x, dim, mesh.groups_group, s.parts["groups"],
                               mesh.group_index)


def unit_span(axis: str):
    """(start, total) of this rank's units of data axis ``axis``
    ('groups' or 'subjects') when a group-sharded run splits it, else
    None: the ``units`` argument of the step wrappers."""
    s = _ACTIVE
    if s is None or not s.split(axis):
        return None
    start, _, total = s.spans[axis]
    return start, total


def local_count(axis: str | None, total: int) -> int:
    """How many of the ``total`` units of data axis ``axis`` this rank
    holds: its span's length when the active shard splits the axis, else
    ``total``."""
    s = _ACTIVE
    if axis is None or s is None or not s.split(axis):
        return total
    return s.spans[axis][1]


def unit_draw(axis: str | None, dim: int = 1):
    """The ``units`` argument of an rng draw whose tensor's ``dim`` is
    the unit axis of data axis ``axis``: (dim, u0, U) when this rank holds
    units u0.. of U, (dim, 0, None) when it holds them all; None when
    ``axis`` is None (no unit axis: a draw from the device generator)."""
    if axis is None:
        return None
    span = unit_span(axis)
    return (dim, 0, None) if span is None else (dim, *span)


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
    name of the shard's spans, or, on the last split dim only,
    (positions, total): that dim holds entries ``positions[j]`` (a long
    tensor for each group shard j, this rank's at its group index) of
    ``total``. The ranks that hold the other parts (of the chains, the
    units, or both) all_gather their parts, padded to the longest, and
    each rank copies every part into the place the shard gives it."""
    s = shard if shard is not None else _ACTIVE
    split = []                          # (dim, on chains, places, total)
    for dim, item in enumerate(spec):
        if item is None:
            continue
        if isinstance(item, str):
            if s.split(item):
                split.append((dim, item == "chains", s.parts[item],
                              s.spans[item][2]))
        else:
            split.append((dim, False, *item))
    if not split:
        return x
    mesh = s.mesh
    on_chains = {c for _, c, _, _ in split}
    if on_chains == {True}:
        group = mesh.chains_group
        coords = [(i, mesh.group_index) for i in range(mesh.chain_shards)]
    elif on_chains == {False}:
        group = mesh.groups_group
        coords = [(mesh.chain_index, j) for j in range(mesh.group_shards)]
    else:                                       # every rank, in rank order
        group = None
        coords = [divmod(r, mesh.group_shards)
                  for r in range(mesh.chain_shards * mesh.group_shards)]
    places = [[where[i if c else j] for _, c, where, _ in split]
              for i, j in coords]
    dims = [dim for dim, _, _, _ in split]
    parts = _all_gather_padded(
        x, dims, [[p[1] if isinstance(p, tuple) else len(p) for p in pl]
                  for pl in places], group)
    shape = list(x.shape)
    for dim, _, _, total in split:
        shape[dim] = total
    out = x.new_empty(shape)
    for part, pl in zip(parts, places):
        view = out
        for dim, p in zip(dims, pl):
            if not isinstance(p, tuple):        # positions, the last dim
                view.index_copy_(dim, p.to(x.device), part)
                break
            view = view.narrow(dim, *p)
        else:
            view.copy_(part)
    return out


def gather_to_primary(x, spec, shard):
    """The global tensor of which ``x`` is this rank's part, as a CPU
    tensor on the primary (rank 0), None on every other rank: each rank
    sends its part, padded to the longest along the split dims, with one
    ``gather`` over every rank, and only the primary allocates the global
    extents (a checkpoint's carry, which only the primary writes). gloo
    gathers host tensors only, so there the parts travel as CPU copies;
    NCCL gathers them on the card. spec: one axis name or None a leading
    dim of ``x``."""
    s = shard
    mesh = s.mesh
    primary = dist.get_rank() == 0
    split = [(dim, item) for dim, item in enumerate(spec)
             if item is not None and s.split(item)]
    if not split:
        return x.cpu() if primary else None
    world = mesh.chain_shards * mesh.group_shards
    # (start, length) along each split dim of rank r = (i, j)'s part
    places = [[s.parts[item][i if item == "chains" else j]
               for _, item in split]
              for i, j in (divmod(r, mesh.group_shards)
                           for r in range(world))]
    part = x
    for k, (dim, _) in enumerate(split):
        longest = max(pl[k][1] for pl in places)
        if part.shape[dim] < longest:
            pad = list(part.shape)
            pad[dim] = longest - part.shape[dim]
            part = torch.cat([part, part.new_zeros(pad)], dim=dim)
    part = part.cpu() if dist.get_backend() == "gloo" else part
    part = part.contiguous()
    bufs = [torch.empty_like(part) for _ in range(world)] if primary else None
    dist.gather(part, bufs, dst=0)
    if not primary:
        return None
    shape = list(x.shape)
    for dim, item in split:
        shape[dim] = s.spans[item][2]
    out = torch.empty(shape, dtype=x.dtype)
    for buf, pl in zip(bufs, places):
        view = out
        for (dim, _), (start, n) in zip(split, pl):
            view, buf = view.narrow(dim, start, n), buf.narrow(dim, 0, n)
        view.copy_(buf)
    return out


def global_mean(x, spec, shard):
    """The mean of the global tensor of which ``x`` is this rank's part,
    on every rank (a 0-d float32 tensor): the part's float64 sum, summed
    over the ranks that hold the other parts (all_reduce over the chain
    shards, then the group shards, where the spec splits each), over the
    global element count."""
    total = x.double().sum()
    count = x.numel()
    for axis in spec:
        if axis is None or not shard.split(axis):
            continue
        _, length, full = shard.spans[axis]
        count = count // length * full
        dist.all_reduce(total, group=(shard.mesh.chains_group
                                      if axis == "chains"
                                      else shard.mesh.groups_group))
    return (total / max(count, 1)).float()


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on some rank."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def lockstep(failed: bool, digest: int, device) -> tuple:
    """(some rank failed, every rank gave the same ``digest``) on every
    rank: one all_reduce(MAX) of (failed, digest, -digest) over the
    default group (segments.py's check, before a segment's replays, that
    no rank's capture failed and that every rank replays the same
    graphs in the same order)."""
    t = torch.tensor([int(failed), digest, -digest], dtype=torch.int64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    bad, hi, neg_lo = t.tolist()
    return bool(bad), hi == -neg_lo
