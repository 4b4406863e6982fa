"""Chain orchestration: warmup, then sampling, each a program of steps on a
static carry, replayed as a captured CUDA graph on the card.

Port of :mod:`nestmc.engine`, one device a process. As the reference has
two compiled hot programs, the port has two steps (segments.py): a warmup
sweep and a sampling draw, each reading and writing a carry held in fixed
buffers, with what changes between sweeps (the kernels' Philox key words,
the Robbins-Monro gain, the R-hat fold's scalars) read from device tables
filled before each segment. The loop is chosen before the run, from
the device, the mesh and the backend alone (segments.capturable), and
``timings["sweep"]`` records it: on the card each step is captured once
as a CUDA graph and replayed (``"graph"``: between the draws of a segment
the host only launches) when the run is unsharded, when it is sharded but
its step issues no collective (chains split, one group shard), and when
the backend is NCCL (one card a rank), whose all_reduces over groups the
graphs hold, as the reference's compiled segments hold XLA's psums; a
step with collectives over gloo (ranks sharing a card) and every run on
the CPU step eagerly (``"eager"``). A capture that fails raises on its
rank, and every other rank of the run raises too: there is no
fallback. The two phases stay separate and the metric freezes at warmup end
(KernelConfig.newton_freeze). Each retained draw takes RunConfig.thin
sweeps. Retained draws (RunConfig.collect: blocks, and the model's
derived quantities computed from the position) go into buffers of shape
(C, D', ...), allocated at the first draw, D' the draws this call runs,
each draw written at its column by the step. With RunConfig.full_rhat
every block streams split-R-hat Welford accumulators; blocks whose fused
step folds them in-kernel (kernels/gibbs.rhat_fold_names) fold each draw
in the draw's first sweep, one draw late, with the pre-update value, and
the last draw is flushed after the loop. With RunConfig.full_rhat_thin =
k > 1 nothing folds in-kernel: every block's accumulators are updated
after the draw's sweeps, on retained draws j with j % k == 0 only (as
thinned draw j // k).

Both phases run in segments of RunConfig.segment_size sweeps (warmup) or
draws (sampling). After a segment the engine may log its rate (and with
RunConfig.log_rhat the worst split R-hat of the draws so far), check the
position for NaN (``debug_nans``) and, after every
RunConfig.checkpoint_every-th segment, save the carry (checkpoint.py):
the KernelState and the RNG's states, and in sampling the streamed
accumulators too. A run resumes from such a carry: ``init_state`` and the
RNG's restored state; ``skip_warmup`` for a sample-phase checkpoint; and
``init_acc`` with ``draws_offset`` continue the accumulators over the full
schedule, so only the remaining draws run and the gate still covers every
draw. The draw pending in the one-draw-late fold is the carry's position:
the first resumed sweep folds it, once. Timings synchronise the device
before every clock read; ``timings["capture_s"]``, the seconds the two
captures took (a probe step and a capture each), is kept out of
``warmup_s`` and ``sample_s``.

A sharded run (ShardingConfig; one process a rank, parallel/multihost)
runs the same loop on this rank's part (parallel/sharding.py): each rank
builds only its part of the carry (sharding.shard_state: the positions
drawn at their global shapes and cut at once, the rest built from them on
the rank's data; a resumed run's global carry is cut, a rank part of the
same mesh taken as it is), the rng fills only the rank's block of every
unit-axis draw (rng.py), and the sums over a group-sharded unit axis are
all_reduces (parallel/collectives.groups_sum). The streamed R-hat and
ESS are finalized where the units live (:func:`_finalize`), and only
their maps, which have no chain axis, are gathered. The rank keeps its
part of the final carry and of the acceptance rates: its Posterior's
``final_state``, ``accept_rates`` and ``warmup_accept_rates`` are the
rank's parts, placed by ``Posterior.placement``
(parallel.gather_state / gather_rates give the global layout on
request), with the global mean acceptance of each block reduced where
the rates live (``Posterior.accept_mean``). The collected draws are
gathered to the global layout on every rank. A checkpoint's carry is
gathered to the primary alone, which writes it
(collectives.gather_to_primary), so a resume may use any topology.
Per-rank logs come from the primary, over its own chains and units.

On a card, ``timings`` holds two memory readings, each the peak of
torch.cuda.max_memory_allocated since sample()'s entry less the memory
allocated at that entry (the caller's own tensors), in GB:
``peak_mem_gb`` through the last sweep and the finalize, and
``peak_mem_gb_gather`` through the final gathers (the draws) too. Each
segment runs under a profiler span, ``nestmc.warmup.seg{i}`` or
``nestmc.sample.seg{i}`` (utils/profiling.span), as the reference's, and
the fold flush and the finalize of the streamed R-hat under
``nestmc.finalize``. With ``spans`` the draw step records its
device-timed spans (segments.py, kernels/gibbs.py): ``timings`` gains
``"spans"`` (utils/profiling.Spans.summary: each span's parent, role and
ms a sweep) and ``"spans_clock"`` (the stamps' offset from the profiler's
clock, utils/profiling.clock_offset), and ``Posterior.spans`` holds the
recorder (its ``events()`` are the track utils/profiling.add_track adds
to a trace).

Not ported: the reference's remote-backend warm-up and compile retries.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from nestmc_torch.checkpoint import checkpoint_tag, save_checkpoint
from nestmc_torch.config import SamplerConfig, validate
from nestmc_torch.data import data_device
from nestmc_torch.diagnostics import (
    fold_ess_finalize,
    fold_rhat_finalize,
    fold_rhat_init,
    fold_rhat_scalars,
    fold_rhat_update,
    split_rhat,
    streaming_ess_finalize,
    streaming_rhat_finalize,
    streaming_rhat_init,
)
from nestmc_torch.kernels.gibbs import make_sweep, rhat_fold_names
from nestmc_torch.kernels.state import KernelState, init_kernel_state
from nestmc_torch.model import ModelSpec
from nestmc_torch.parallel.collectives import (
    activate,
    any_rank,
    gather,
    gather_to_primary,
    global_mean,
    lockstep,
)
from nestmc_torch.parallel.multihost import backend, is_primary
from nestmc_torch.parallel.sharding import (
    Placement,
    make_mesh,
    make_shard,
    map_specs,
    shard_state,
    state_shardings,
    take,
)
from nestmc_torch.posterior import Posterior
from nestmc_torch.rng import SweepRNG
from nestmc_torch.segments import DrawProgram, WarmupProgram, capturable
from nestmc_torch.utils.logging import get_logger
from nestmc_torch.utils.profiling import span

log = get_logger()


def _collect(position, spec, derived, index):
    """{name: (C, *shape)} of what RunConfig.collect retains: block names
    and the model's derived quantities (computed from the position), all
    of both when ``spec`` is None. index: {name: long device tensor} of
    each selection taken by index (:func:`_collect_index`)."""
    if spec is None:
        return {**position, **{k: fn(position) for k, fn in derived.items()}}
    out = {}
    for name, k in spec.items():
        v = derived[name](position) if name in derived else position[name]
        if name in index:
            out[name] = v.index_select(1, index[name])
        elif k is None:
            out[name] = v
        else:
            out[name] = v[:, :k]
    return out


def _collect_index(spec, picks, device) -> dict:
    """{name: long tensor on ``device``} of each collected selection taken
    by index: the rank's picks on a group-sharded unit axis
    (:func:`_unit_picks`), or a list of indices. Made once before the
    steps, so that a captured step copies nothing from the host."""
    out = {}
    for name, k in (spec or {}).items():
        if name in picks:
            out[name] = picks[name][0].to(device)
        elif k is not None and not isinstance(k, int):
            out[name] = torch.as_tensor(k, dtype=torch.long, device=device)
    return out


def _unit_picks(model, spec, shard) -> dict:
    """{name: (local index, positions, total)} for each collected
    selection (an int k or indices) of a quantity whose unit axis the
    shard splits: the selected units this rank holds, the places in the
    selection of each group shard's selected units, and its length."""
    picks = {}
    if shard is None or spec is None:
        return picks
    for name, k in spec.items():
        axis = model.unit_axes.get(name)
        if k is None or axis is None or not shard.split(axis):
            continue
        start, _, total = shard.spans[axis]
        sel = (list(range(min(k, total))) if isinstance(k, int)
               else [int(i) for i in k])
        pos = [[i for i, u in enumerate(sel) if a <= u < a + n]
               for a, n in shard.parts[axis]]
        mine = pos[shard.mesh.group_index]
        picks[name] = (torch.tensor([sel[i] - start for i in mine],
                                    dtype=torch.long),
                       [torch.tensor(p, dtype=torch.long) for p in pos],
                       len(sel))
    return picks


def _draw_spec(model, name, shard, picks) -> tuple:
    """The gather spec of a (C, D, ...) draws buffer."""
    if name in picks:
        return ("chains", None, picks[name][1:])
    axis = model.unit_axes.get(name)
    return ("chains", None, axis) if axis and shard.split(axis) else (
        "chains",)


def _map_acc(fn, acc, pos_specs):
    """fn(tensor, spec) over the streamed accumulators (std_acc,
    fold_acc), each spec derived from its block's position spec: the
    standard layout (C, 2, ...) and the kernel layout (2, ..., C)."""
    std_acc, fold_acc = acc

    def std(spec):
        return (spec[0], None) + tuple(spec[1:])

    def fold(spec, ndim):
        out = [None] * ndim
        out[-1] = "chains"
        for i, axis in enumerate(spec[1:]):
            out[1 + i] = axis
        return tuple(out)

    return (
        {k: (c, fn(m, std(pos_specs[k])), fn(m2, std(pos_specs[k])))
         for k, (c, m, m2) in std_acc.items()},
        {k: (c, fn(m, fold(pos_specs[k], m.ndim)),
             fn(m2, fold(pos_specs[k], m2.ndim)))
         for k, (c, m, m2) in fold_acc.items()},
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem_entry(device):
    """The memory allocated at sample()'s entry, with the peak statistics
    reset there; None off the card."""
    if device.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _mem_peak(timings, key, device, mem0) -> None:
    """timings[key]: the peak allocated since the entry, less mem0, GB."""
    if mem0 is not None:
        timings[key] = (torch.cuda.max_memory_allocated(device) - mem0) / 1e9


def _finalize_maps(std_acc, fold_acc):
    """(R-hat, ESS) maps of a run's accumulators, as one device holds them."""
    return ({**streaming_rhat_finalize(std_acc),
             **fold_rhat_finalize(fold_acc)},
            {**streaming_ess_finalize(std_acc),
             **fold_ess_finalize(fold_acc)})


def _finalize(acc, shard, specs):
    """(full_rhat, full_ess) of the streamed accumulators (std_acc,
    fold_acc), in the global layout on every rank.

    Sharded, each rank finalizes the units it holds, never (C, units) at
    the global extents: with its chains whole (chains not split), its own
    accumulators; with the chains split, one slice of its units at a time,
    gathered over the chain shards (mesh.chains_group) and finalized before
    the next, chain_shards slices of a block, so a slice gathered is the
    size of the rank's own part. Only the maps, which have no chain axis,
    are then gathered over the group shards. The finalize reduces over the
    chains alone, so the maps are the gathered accumulators' maps up to
    the last bits (PyTorch picks a reduction's summation order by the
    tensor's extents; within 1e-6 relative, tests/test_torch_sharding)."""
    std_acc, fold_acc = acc
    if shard is None:
        return _finalize_maps(std_acc, fold_acc)
    split = shard.split("chains")
    rhat, ess = {}, {}
    for fold, accs in ((False, std_acc), (True, fold_acc)):
        # std (C, 2, *dims), fold (2, *dims, C): the chains' dim and the
        # first of the leaf's own dims
        for k, (count, mean, m2) in accs.items():
            cdim, udim = (mean.ndim - 1, 1) if fold else (0, 2)
            parts = [(mean, m2)]
            if split and mean.ndim > 2:
                n = min(shard.mesh.chain_shards, mean.shape[udim])
                parts = zip(mean.tensor_split(n, udim),
                            m2.tensor_split(n, udim))
            pieces = []
            for pm, pm2 in parts:
                if split:
                    spec = tuple("chains" if d == cdim else None
                                 for d in range(pm.ndim))
                    pm, pm2 = gather(pm, spec, shard), gather(pm2, spec,
                                                              shard)
                one = ({}, {k: (count, pm, pm2)}) if fold else (
                    {k: (count, pm, pm2)}, {})
                r, e = _finalize_maps(*one)
                pieces.append((r[k], e[k]))
            spec = tuple(specs.position[k][1:])

            def whole(maps):
                out = maps[0] if len(maps) == 1 else torch.cat(maps)
                return gather(out, spec, shard)
            rhat[k] = whole([r for r, _ in pieces])
            ess[k] = {q: whole([e[q] for _, e in pieces])
                      for q in pieces[0][1]}
    return rhat, ess


def _gather_out(model, draws, shard, picks):
    """The collected draws of a sharded run, gathered to the global layout
    on every rank (the one leaf with a chain axis that every rank's
    Posterior holds whole: a selection of the units, not the units)."""
    return {k: gather(v, _draw_spec(model, k, shard, picks), shard)
            for k, v in draws.items()}


def _segments(total: int, segment: int):
    segment = max(1, min(segment, total)) if total else 0
    done = 0
    while done < total:
        n = min(segment, total - done)
        yield done, n
        done += n


def _zero_accept(state: KernelState) -> KernelState:
    return dataclasses.replace(state, accept_sum={
        k: torch.zeros_like(v) for k, v in state.accept_sum.items()})


def _check_nans(state: KernelState, phase: str, done: int) -> None:
    for k, v in state.position.items():
        if bool(torch.isnan(v).any()):
            raise FloatingPointError(
                f"NaN in position[{k!r}] after the {phase} segment ending "
                f"at {done}")


def sample(
    model: ModelSpec,
    data,
    cfg: SamplerConfig | None = None,
    rng: SweepRNG | None = None,
    init_state: KernelState | None = None,
    skip_warmup: bool = False,
    init_acc=None,
    draws_offset: int = 0,
    debug_nans: bool = False,
    spans: bool = False,
    _eager: bool = False,
) -> Posterior:
    """Run the sampler on the data's device (data_device: its ``device``,
    else that of its first tensor); returns a :class:`Posterior`.

    rng: the run's noise, SweepRNG(cfg.run.seed) by default (a resumed run
    passes one restored from the checkpoint). init_state: the carry to
    start from instead of the model's init (its warmup still runs unless
    ``skip_warmup``, whose accept bookkeeping restarts). init_acc,
    draws_offset: the streamed accumulators (std_acc, fold_acc) of the
    first ``draws_offset`` retained draws; cfg.run.draws stays the whole
    schedule and only the remaining draws run. A full_rhat run resumed
    past draw 0 without them raises: its gate would cover the remaining
    draws only. debug_nans: raise FloatingPointError at the first segment
    whose position holds a NaN. spans: record the draw step's
    device-timed spans (off by default; the module's notes). A sharded
    config (cfg.sharding) runs as
    one rank of a multi-process run: every rank passes the same full
    data, and init_state and init_acc either in the global layout (cut
    here) or as this rank's part on the same mesh (a sharded run's
    final_state, warmup_then_state's). _eager (private,
    for the card's A/B of the two loops and for timed collectives,
    collectives.TIMING): step a run on the card eagerly instead of
    replaying its captured steps.
    """
    cfg = cfg or SamplerConfig()
    validate(cfg)
    rc = cfg.run
    streamed = rc.full_rhat and rc.draws > 0
    if streamed and draws_offset > 0 and init_acc is None:
        raise ValueError(
            f"draws_offset={draws_offset} with full_rhat needs init_acc, "
            "the accumulators of the draws before it: without them the "
            "gate would certify the remaining draws only")
    device = data_device(data)
    mem0 = _mem_entry(device)
    if rng is None:
        rng = SweepRNG(rc.seed, device)
    mesh = make_mesh(cfg)

    _sync(device)
    t_setup = time.perf_counter()
    resumed = init_state is not None
    shard = None
    if mesh is None:
        state = (init_state if resumed
                 else init_kernel_state(model, cfg, rng, data))
    else:
        # this rank's part only: a resumed run's global carry is cut (a
        # rank part kept), a fresh one built per shard
        shard = make_shard(model, data, cfg, mesh)
        specs = state_shardings(model, cfg, mesh)

        def cut(t, spec):
            return take(t, spec, shard.spans)

        state = (map_specs(cut, specs, init_state) if resumed
                 else shard_state(model, cfg, rng, shard))
        if init_acc is not None:
            init_acc = _map_acc(cut, init_acc, specs.position)
        data = shard.local
        c0, cl, C = shard.spans["chains"]
        rng.chains = (c0, C) if cl != C else None
    sweep = make_sweep(model, cfg)
    graph = capturable(device, mesh, backend(), _eager)
    _sync(device)
    timings = {"setup_s": time.perf_counter() - t_setup,
               "checkpoint_s": 0.0, "checkpoints": 0,
               "sweep": "graph" if graph else "eager", "capture_s": 0.0}
    try:
        with activate(shard):
            return _run(model, data, cfg, rng, state, sweep, timings, shard,
                        skip_warmup, resumed, init_acc,
                        draws_offset, debug_nans, mem0, graph, spans)
    finally:
        if shard is not None:
            rng.chains = None


def _run(model, data, cfg, rng, state, sweep, timings, shard, skip_warmup,
         resumed, init_acc, draws_offset, debug_nans, mem0,
         graph, spans) -> Posterior:
    """sample()'s two phases on this rank's carry (the whole carry
    unsharded), then the gather of what the Posterior holds. graph: replay
    each phase's captured step (segments.py), else step eagerly. spans:
    the draw step records its spans."""
    rc = cfg.run
    D = rc.draws
    streamed = rc.full_rhat and D > 0
    device = data_device(data)
    primary = shard is None or is_primary()
    specs = (state_shardings(model, cfg, shard.mesh) if shard is not None
             else None)

    def to_primary(t, spec):
        return gather_to_primary(t, spec, shard)

    def nan_check(st, phase, done):
        if shard is None:
            _check_nans(st, phase, done)
            return
        bad = any(bool(torch.isnan(v).any()) for v in st.position.values())
        if any_rank(bad, device):
            _check_nans(st, phase, done)
            raise FloatingPointError(
                f"NaN in another rank's position after the {phase} "
                f"segment ending at {done}")

    def checkpoint(seg_idx, phase, count, carry, extra):
        if (not rc.checkpoint_dir or rc.checkpoint_every <= 0
                or (seg_idx + 1) % rc.checkpoint_every):
            return
        t_c = time.perf_counter()
        if shard is not None:
            # gathered to the primary alone, which writes it (every rank's
            # generators are the same: the primary's suffice)
            carry = {**carry, "state": map_specs(to_primary, specs,
                                                 carry["state"])}
            if "acc" in carry:
                carry["acc"] = _map_acc(to_primary, carry["acc"],
                                        specs.position)
        tag = checkpoint_tag(phase, count)
        if primary:
            save_checkpoint(rc.checkpoint_dir, tag, carry,
                            {"phase": phase, "config": cfg.to_dict(),
                             **extra})
            log.info("checkpoint saved: %s/%s", rc.checkpoint_dir, tag)
        timings["checkpoint_s"] += time.perf_counter() - t_c
        timings["checkpoints"] += 1

    # both phases' graphs share one memory pool
    pool = torch.cuda.graph_pool_handle() if graph else None
    # a sharded run's ranks check before each segment's replays that every
    # capture succeeded and that they replay the same graphs
    agree = (functools.partial(lockstep, device=device)
             if graph and shard is not None else None)

    # ---- warmup: refreshed metric ----
    warm_rates = {k: torch.zeros_like(v) for k, v in state.accept_sum.items()}
    t_w = time.perf_counter()
    capture_w = 0.0
    if not skip_warmup and rc.warmup > 0:
        segs = list(_segments(rc.warmup, rc.segment_size))
        prog = WarmupProgram(sweep, state, data, rng, cfg,
                             max(n for _, n in segs), graph, pool, agree)
        state = prog.state()
        for i, (start, n) in enumerate(segs):
            with span(f"warmup.seg{i}"):
                prog.run(n)
            state = prog.state()
            if rc.log_every_segment and primary:
                _sync(device)
                log.info("warmup: %d/%d sweeps (%.0f sweeps/s)",
                         start + n, rc.warmup,
                         (start + n) / max(time.perf_counter() - t_w, 1e-9))
            if debug_nans:
                nan_check(state, "warmup", start + n)
            checkpoint(i, "warmup", state.t,
                       {"state": state, "rng": rng.get_state()},
                       {"sweeps_done": state.t, "has_acc": False})
        # released before the sampling step is captured
        prog.close()
        capture_w = prog.capture_s
        warm_rates = {k: v / rc.warmup for k, v in state.accept_sum.items()}
        state = _zero_accept(state)
    elif resumed and skip_warmup:
        # the carry's accept sums belong to sweeps this call did not run
        state = _zero_accept(state)
    _sync(device)
    timings["warmup_s"] = time.perf_counter() - t_w - capture_w

    # ---- sampling: frozen metric, thin sweeps a retained draw ----
    remaining = max(D - draws_offset, 0)
    rthin = rc.full_rhat_thin
    half_len = (D // rthin) // 2
    std_acc, fold_acc = {}, {}
    if streamed:
        if init_acc is not None:
            std_acc, fold_acc = init_acc
        else:
            folds = rhat_fold_names(model, cfg)
            std_acc = streaming_rhat_init({
                k: v for k, v in state.position.items() if k not in folds
            })
            fold_acc = fold_rhat_init(state.position, folds)
    fold_names = tuple(fold_acc)
    picks = _unit_picks(model, rc.collect, shard)
    index = _collect_index(rc.collect, picks, device)
    draws = {}

    _sync(device)
    t_s = time.perf_counter()
    capture_s = 0.0
    recorded = None
    if remaining > 0:
        segs = list(_segments(remaining, rc.segment_size))
        prog = DrawProgram(
            sweep, state, data, rng, cfg, std_acc, fold_acc,
            lambda pos: _collect(pos, rc.collect, model.derived, index),
            remaining, draws_offset, half_len, max(n for _, n in segs),
            graph, pool, agree, spans)
        # the program's copies from here: the engine's first accumulators
        # and carry are let go
        state = prog.state()
        std_acc, fold_acc = prog.acc()
        draws = prog.draws
        for i, (start, n) in enumerate(segs):
            with span(f"sample.seg{i}"):
                prog.run(n, draws_offset + start)
            state = prog.state()
            std_acc, fold_acc = prog.acc()
            done = draws_offset + start + n
            if rc.log_every_segment and primary:
                _sync(device)
                extra = ""
                if rc.log_rhat and start + n >= 8 and draws:
                    worst = max(float(split_rhat(v[:, :start + n]).max())
                                for v in draws.values())
                    extra = f", worst split-rhat so far {worst:.4f}"
                log.info("sample: %d/%d draws (%.0f sweeps/s)%s", done, D,
                         (start + n) * rc.thin
                         / max(time.perf_counter() - t_s - prog.capture_s,
                               1e-9), extra)
            if debug_nans:
                nan_check(state, "sample", done)
            carry = {"state": state, "rng": rng.get_state()}
            if streamed:
                carry["acc"] = (std_acc, fold_acc)
            checkpoint(i, "sample", done, carry,
                       {"draws_done": done, "has_acc": streamed})
        prog.close()
        capture_s = prog.capture_s
        recorded = prog.spans
    _sync(device)
    timings["sample_s"] = time.perf_counter() - t_s - capture_s
    timings["capture_s"] = capture_w + capture_s
    timings["draws_run"] = remaining
    if recorded is not None:
        timings["spans"] = recorded.summary(model.unit_axes, rc.thin)
        timings["spans_clock"] = recorded.clock

    full_rhat = full_ess = None
    with span("finalize"):
        if streamed:
            if fold_names:
                # the in-sweep fold lags one draw: flush the last retained
                # draw, the position, if the thinning selects it
                last = D - 1
                last_t = last // rthin if last % rthin == 0 else -1
                fold_acc = dict(fold_acc)
                for k in fold_names:
                    count, mean, m2 = fold_acc[k]
                    sc = fold_rhat_scalars(count, last_t, half_len)
                    nm, nm2 = fold_rhat_update(
                        mean, m2, state.position[k].movedim(0, -1), sc
                    )
                    fold_acc[k] = (count + sc[:, 1], nm, nm2)
            full_rhat, full_ess = _finalize((std_acc, fold_acc), shard,
                                            specs)
    _mem_peak(timings, "peak_mem_gb", device, mem0)

    rates = {k: v / max(remaining * rc.thin, 1)
             for k, v in state.accept_sum.items()}
    placement = accept_mean = None
    if shard is not None:
        t_g = time.perf_counter()
        draws = _gather_out(model, draws, shard, picks)
        accept_mean = {k: global_mean(v, specs.accept_sum[k], shard)
                       for k, v in rates.items()}
        placement = Placement(shard, specs)
        _sync(device)
        timings["gather_s"] = time.perf_counter() - t_g
    _mem_peak(timings, "peak_mem_gb_gather", device, mem0)
    post = Posterior(
        draws=draws,
        accept_rates=rates,
        warmup_accept_rates=warm_rates,
        config=cfg.to_dict(),
        timings=timings,
        full_rhat=full_rhat,
        full_ess=full_ess,
        placement=placement,
        accept_mean=accept_mean,
        spans=recorded,
    )
    post.final_state = state
    return post


def warmup_then_state(model, data, cfg: SamplerConfig,
                      rng: SweepRNG | None = None) -> KernelState:
    """Run only the warmup phase and return the adapted carry: in a
    sharded run this rank's part of it, which ``sample(init_state=...)``
    takes on the same mesh."""
    cfg2 = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                            draws=0))
    return sample(model, data, cfg2, rng).final_state
