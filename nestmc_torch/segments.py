"""The compiled segment programs: the warmup sweep and the sampling draw,
each a step on a static carry, run eagerly or, on the card, captured once
as a CUDA graph and replayed.

Port of the reference's execution model (nestmc/engine.py, build_step_fns:
two compiled hot programs, the adapting warmup segment and the frozen
sampling segment with the in-sweep R-hat fold, each a lax.scan over
sweeps with no host round trip between draws; sharded, the same programs
with XLA's psums over groups inside them):

- The carry lives in fixed buffers (the counterpart of the reference's
  donated carry): a step reads them and copies its result back into them.
  A warmup step is one sweep; a sampling step is one retained draw: its
  first sweep with the fold, the thin - 1 plain sweeps, the streamed
  R-hat update, and the collected quantities written into the draws
  buffers at the draw's column.
- What differs from step to step reaches it through device tables that
  the host fills before each segment, read at device counters the step
  advances: each sweep's Philox key words (SweepRNG.key_table: the words
  of as many successive philox_key() calls, in launch order), each warmup
  sweep's Robbins-Monro gain (rm_step_size, float32), each draw's fold
  scalars (diagnostics.fold_rhat_table), streamed-update flags and counts
  (diagnostics.streaming_rhat_table) and draws column. The host keeps the
  sweep count, the draw count and the accumulators' counts, and advances
  them by the segment's length.
- Which loop runs is decided before the run, by :func:`capturable`, from
  the device, the mesh and the backend alone, never by catching a
  failure: captured on the card unless the caller asks for the eager loop
  (``sample(..., _eager=True)``), when the run is unsharded, when its step
  issues no collective (one group shard: a chain shard's step is the
  unsharded step on its chains), or when the backend is NCCL, whose
  collectives a graph records; eager on the CPU, and for a step with
  collectives over gloo (ranks sharing a card), which goes through the
  host. Eagerly each step runs as written and each kernel launch draws
  its key words when it asks.
- Captured, the step first runs once eagerly on a side stream with its
  results discarded (so that every kernel's attributes, the libraries'
  workspaces, the draws buffers and the NCCL communicators of the mesh's
  process groups exist, and to count the key words a sweep takes), the
  device generator and the counts put back; then it is captured on that
  stream with the run's device generator registered, so that each replay
  advances the generator as the eager step would, and each segment
  replays it. Every rank of a sharded run takes the same key words a
  sweep (a launch a group shard skips still takes its pair:
  SweepRNG.skip_key), captures the same variants in the same order and
  replays them in lockstep; before a segment's replays the ranks check
  over the default group that every capture succeeded and that the
  variants agree (collectives.lockstep), and all of them raise if not,
  so no rank waits in a replayed collective for a rank that stopped.
  Both phases' graphs draw on one memory pool (the clones and gathers of
  the captured collectives too), and the warmup graph is released before
  the sampling graph is captured. The host counts made at the capture,
  kernel launches (ops/cuda.LAUNCHES) and collective calls
  (collectives.STATS), are counted again at each replay. A capture that
  fails raises; there is no eager retry.
"""

from __future__ import annotations

import time
import zlib

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from nestmc_torch.adapt import rm_step_size
from nestmc_torch.diagnostics import (
    fold_rhat_table,
    streaming_rhat_table,
    streaming_rhat_update_at,
)
from nestmc_torch.kernels.state import KernelState
from nestmc_torch.ops.cuda import LAUNCHES
from nestmc_torch.parallel.collectives import STATS

# key word pairs the probe step offers one sweep (a sweep of a built-in
# model takes one a fused step, a few with size buckets)
_PROBE_KEYS = 4096


def capturable(device, mesh, backend, eager: bool) -> bool:
    """Whether a run replays its steps as captured CUDA graphs (True:
    ``timings["sweep"] == "graph"``) or steps eagerly: on the card, not
    asked for the eager loop, and unsharded (``mesh`` None), or sharded
    with a step that issues no collective (one group shard: every rank's
    step is the unsharded step on its chains; with two or more, every
    rank's unit axis is split and its sums over units are all_reduces),
    or on a backend whose collectives a graph records (NCCL; gloo's go
    through the host). The same answer on every rank of a run."""
    if torch.device(device).type != "cuda" or eager:
        return False
    return mesh is None or mesh.group_shards == 1 or backend == "nccl"


def _counts() -> dict:
    """The host counts a replay repeats: kernel launches and collective
    calls."""
    return {**{("launch", k): v for k, v in LAUNCHES.items()},
            **{("stat", k): v for k, v in STATS.items()}}


def _restore(saved: dict) -> None:
    for (kind, k), v in saved.items():
        (LAUNCHES if kind == "launch" else STATS)[k] = v


def _state_tree(state: KernelState) -> dict:
    return {"position": state.position, "log_scale": state.log_scale,
            "accept_sum": state.accept_sum, "cache": state.cache,
            "precond": state.precond}


class _Program:
    """One phase's step on a static carry (a pytree of tensors), with its
    per-step tables. Subclasses define ``_compute(carry, rows, variant)``
    -> the next carry and ``_tables(n, ...)`` -> {name: (n, ...) host
    table} for the next n steps, and may define ``_variants``: a step
    whose work the host knows to differ from draw to draw (the thinned
    streamed update) has a variant for each, each captured as a graph of
    its own, all sharing the pool (replayed one at a time on one stream,
    and no graph's memory holds a value past its replay). agree: in a
    sharded run that captures, collectives.lockstep on the run's device
    (failed, digest) -> (some rank failed, all digests equal)."""

    def __init__(self, carry, device, capacity: int, sweeps: int, rng,
                 graph: bool, pool, agree=None):
        self.device = torch.device(device)
        leaves, self._spec = tree_flatten(carry)
        # the step's buffers: copies, so a caller's carry is never written
        self._leaves = [t.clone() if torch.is_tensor(t) else t
                        for t in leaves]
        self.capacity = capacity        # steps a segment, at most
        self.sweeps = sweeps            # sweeps a step
        self.rng = rng
        self.graph = graph
        self.pool = pool
        self.agree = agree
        self._tab = {}                  # {name: (capacity, ...) device}
        self.step_i = torch.zeros(1, dtype=torch.long, device=self.device)
        self.sweep_i = torch.zeros(1, dtype=torch.long, device=self.device)
        self._keys = None               # (capacity x sweeps, K, 2) int32
        self.keys_per_sweep = None
        self._mode = "eager"
        self._taken = []                # key words taken a sweep
        self._graphs = {}               # {variant: captured CUDA graph}
        self._replay_counts = {}        # {variant: host counts a replay}
        self.capture_s = 0.0

    # ---- the carry ----
    def carry(self):
        return tree_unflatten(self._leaves, self._spec)

    def _assign(self, new) -> None:
        """Copy the step's result into the buffers. A result that is its
        own buffer (a frozen metric, an unadapted scale) stays; one that
        shares a buffer's memory is copied first, so no buffer is written
        before it is read."""
        leaves, spec = tree_flatten(new)
        if spec != self._spec:
            raise RuntimeError(f"the step changed the carry's structure: "
                               f"{spec} != {self._spec}")
        held = {b.untyped_storage().data_ptr() for b in self._leaves
                if torch.is_tensor(b)}
        pairs = []
        for buf, val in zip(self._leaves, leaves):
            if not torch.is_tensor(buf) or val is buf:
                continue
            if val.untyped_storage().data_ptr() in held:
                val = val.clone()
            pairs.append((buf, val))
        if pairs:
            # one multi-tensor copy (a few launches, not one a leaf)
            torch._foreach_copy_([b for b, _ in pairs], [v for _, v in pairs])

    # ---- the tables ----
    def _rows(self) -> dict:
        """This step's row of every table (device tensors)."""
        return {k: t.index_select(0, self.step_i)[0]
                for k, t in self._tab.items()}

    def _fill(self, tables: dict) -> None:
        """Copy the segment's tables to the device and rewind the
        counters."""
        for k, host in tables.items():
            dev = self._tab.get(k)
            if dev is None:
                dev = self._tab[k] = torch.zeros(
                    (self.capacity,) + tuple(host.shape[1:]),
                    dtype=host.dtype, device=self.device)
            dev[:host.shape[0]].copy_(host.to(self.device))
        self.step_i.zero_()
        self.sweep_i.zero_()

    def _sweep(self, *args, **kwargs):
        """One sweep, its key words set first: none eagerly (each launch
        draws its own), the probe's zeros, or the captured sweep's row of
        the key table, the sweep counter advanced."""
        if self._mode != "eager":
            self._taken.append(self.rng.keys_taken)
            if self._mode == "probe":
                row = self._probe_row
            else:
                row = self._keys.index_select(0, self.sweep_i)[0]
                self.sweep_i.add_(1)
            self.rng.use_keys(row)
        return self.sweep(*args, **kwargs)

    # ---- a step ----
    def _step(self, variant) -> None:
        new = self._compute(self.carry(), self._rows(), variant)
        self._assign(new)
        self.step_i.add_(1)

    def _variants(self, n: int, *table_args) -> list:
        """The variant of each of the next n steps (one unless a subclass
        has more)."""
        return [None] * n

    def run(self, n: int, *table_args) -> None:
        """Run the next n steps: fill the tables for them, then step
        eagerly or replay each step's captured variant (capturing it at
        its first use; sharded, after the ranks' lockstep check)."""
        variants = self._variants(n, *table_args)
        self._fill(self._tables(n, *table_args))
        if not self.graph:
            for v in variants:
                self._step(v)
            return
        failed = True
        try:
            for v in dict.fromkeys(variants):
                if v not in self._graphs:
                    self._capture(v)
            failed = False
        finally:
            if self.agree is not None:
                self._lockstep(failed, variants)
        K = self.keys_per_sweep
        if K:
            words = self.rng.key_table(n * self.sweeps * K)
            self._keys[:n * self.sweeps].copy_(
                words.reshape(n * self.sweeps, K, 2).to(self.device))
        for v in variants:
            self._graphs[v].replay()
        for v in variants:
            for (kind, k), c in self._replay_counts[v].items():
                (LAUNCHES if kind == "launch" else STATS)[k] += c

    def _lockstep(self, failed: bool, variants) -> None:
        """A sharded run's check before a segment's replays: every rank
        captured what it had to, and every rank replays the same variants
        in the same order (they follow from host counters that are equal
        on every rank: checked, not assumed). Otherwise every rank raises,
        a rank whose own capture failed with its own error, and none goes
        on (eagerly or to a replayed collective that would wait for the
        others)."""
        others, same = self.agree(
            failed, zlib.crc32(repr(variants).encode()))
        if failed:
            return
        if others:
            raise RuntimeError("the capture of a step failed on another "
                               "rank: every rank stops")
        if not same:
            raise RuntimeError(f"the ranks would replay different step "
                               f"variants ({variants} on this rank)")

    def _capture(self, variant) -> None:
        """Probe the step once eagerly on a side stream (results discarded:
        the buffers are not written, the device generator and the host
        counts are put back, and the CPU generator is not drawn from, the
        probe's key words being zeros), then capture it on that stream, so
        that what a library makes once a stream (cuBLAS's workspace) or
        once a process group (an NCCL communicator, made at the group's
        first collective) exists before the capture and is not left in
        the graphs' pool."""
        t0 = time.perf_counter()
        rng = self.rng
        gen = rng.generator.get_state()
        counts = _counts()
        self._probe_row = torch.zeros(_PROBE_KEYS, 2, dtype=torch.int32,
                                      device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        self._mode, self._taken = "probe", []
        try:
            with torch.cuda.stream(side):
                self._compute(self.carry(), self._rows(), variant)
            self._taken.append(rng.keys_taken)
        finally:
            rng.use_keys(None)
            self._mode = "eager"
            del self._probe_row
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        rng.generator.set_state(gen)
        _restore(counts)
        taken = self._taken[1:]
        K = taken[0]
        if len(set(taken)) != 1 or self.keys_per_sweep not in (None, K):
            raise RuntimeError(f"the sweeps of a step took {taken} key word "
                               f"pairs ({self.keys_per_sweep} in another "
                               "variant): a captured step needs the same "
                               "count every sweep")
        self.keys_per_sweep = K
        if self._keys is None:
            self._keys = torch.zeros(self.capacity * self.sweeps, K, 2,
                                     dtype=torch.int32, device=self.device)

        g = torch.cuda.CUDAGraph()
        g.register_generator_state(rng.generator)
        self._mode, self._taken = "capture", []
        try:
            # the default capture mode ("global": an unsafe CUDA call of
            # any thread fails the capture) holds the mesh's NCCL
            # collectives too, since ProcessGroupNCCL's watchdog thread
            # does not track captured work (checked on four H100s, torch
            # 2.11, NCCL 2.28)
            with torch.cuda.graph(g, pool=self.pool, stream=side):
                self._step(variant)
            self._taken.append(rng.keys_taken)
        finally:
            rng.use_keys(None)
            self._mode = "eager"
            captured = {k: v - counts[k] for k, v in _counts().items()}
            _restore(counts)
        if self._taken[1:] != [K] * self.sweeps:
            raise RuntimeError(f"the captured sweeps took {self._taken[1:]} "
                               f"key word pairs, the probe's {K} a sweep")
        self._replay_counts[variant] = {k: c for k, c in captured.items()
                                        if c}
        self._graphs[variant] = g
        self.capture_s += time.perf_counter() - t0

    def close(self) -> None:
        """Release the captured graphs (their memory goes back to the
        pool)."""
        for g in self._graphs.values():
            g.reset()
        self._graphs = {}


class WarmupProgram(_Program):
    """The warmup step: one adapting sweep, its Robbins-Monro gain from the
    segment's table."""

    def __init__(self, sweep, state: KernelState, data, rng, cfg,
                 capacity: int, graph: bool, pool, agree=None):
        super().__init__({"state": _state_tree(state)}, state_device(state),
                         capacity, 1, rng, graph, pool, agree)
        self.sweep = sweep
        self.data = data
        self.kcfg = cfg.kernel
        self.t = state.t

    def _tables(self, n: int) -> dict:
        gains = [rm_step_size(self.t + i, self.kcfg) for i in range(n)]
        self.t += n
        return {"gain": torch.tensor(gains, dtype=torch.float32)}

    def _compute(self, carry, rows, variant):
        state = KernelState(**carry["state"], t=self.t)
        new = self._sweep(state, self.data, True, self.rng,
                          gain=rows["gain"])
        return {"state": _state_tree(new)}

    def state(self) -> KernelState:
        """The carry as a KernelState, t the sweeps taken so far."""
        return KernelState(**self.carry()["state"], t=self.t)


class DrawProgram(_Program):
    """The sampling step: one retained draw of ``thin`` frozen sweeps, the
    first folding the previous draw into the kernel-layout accumulators,
    the standard-layout accumulators updated after the last sweep (on the
    draws that fold into them: two variants when full_rhat_thin > 1), and
    the collected quantities written at the draw's column.

    std_acc, fold_acc: the engine's accumulators {name: (count (2,) host,
    mean, m2)}; collect(position) -> {name: (C, ...)}: the quantities a
    draw retains, kept in :attr:`draws` {name: (C, draws_len, ...)},
    allocated at the first draw; draws_offset: the draws before this call
    (draw j goes to column j - draws_offset)."""

    def __init__(self, sweep, state: KernelState, data, rng, cfg, std_acc,
                 fold_acc, collect, draws_len: int, draws_offset: int,
                 half_len: int, capacity: int, graph: bool, pool,
                 agree=None):
        carry = {
            "state": _state_tree(state),
            "fold": {k: (m, m2) for k, (_, m, m2) in fold_acc.items()},
            "std": {k: (m, m2) for k, (_, m, m2) in std_acc.items()},
        }
        super().__init__(carry, state_device(state), capacity,
                         cfg.run.thin, rng, graph, pool, agree)
        self.sweep = sweep
        self.data = data
        self.thin = cfg.run.thin
        self.rthin = cfg.run.full_rhat_thin
        self.collect = collect
        self.draws = {}
        self.draws_len = draws_len
        self.offset = draws_offset
        self.half_len = half_len
        self.t = state.t
        self.counts = {"fold": {k: c for k, (c, _, _) in fold_acc.items()},
                       "std": {k: c for k, (c, _, _) in std_acc.items()}}

    def _variants(self, n: int, j0: int) -> list:
        """Whether each of draws j0.. folds into the standard-layout
        accumulators (every full_rhat_thin-th draw, within the two
        halves)."""
        if not self.counts["std"]:
            return [False] * n
        return [j % self.rthin == 0 and j // self.rthin < 2 * self.half_len
                for j in range(j0, j0 + n)]

    def _tables(self, n: int, j0: int) -> dict:
        js = range(j0, j0 + n)
        out = {"col": torch.tensor([j - self.offset for j in js],
                                   dtype=torch.long)}
        jm1s = [j - 1 if j >= 1 else -1 for j in js]
        for k, count in self.counts["fold"].items():
            out["fold." + k], self.counts["fold"][k] = fold_rhat_table(
                count, jm1s, self.half_len)
        idxs = [j // self.rthin if j % self.rthin == 0 else None for j in js]
        for k, count in self.counts["std"].items():
            act, cnt, self.counts["std"][k] = streaming_rhat_table(
                count, idxs, self.half_len)
            out["act." + k], out["cnt." + k] = act, cnt
        self.t += n * self.thin
        return out

    def _compute(self, carry, rows, update):
        state = KernelState(**carry["state"], t=self.t)
        fold = carry["fold"]
        if fold:
            folds = {k: (m, m2, rows["fold." + k])
                     for k, (m, m2) in fold.items()}
            state, fold = self._sweep(state, self.data, False, self.rng,
                                      folds)
        else:
            state = self._sweep(state, self.data, False, self.rng)
        for _ in range(self.thin - 1):
            state = self._sweep(state, self.data, False, self.rng)
        std = carry["std"]
        if update:
            std = {k: streaming_rhat_update_at(
                {k: (None, m, m2)}, state.position, rows["act." + k],
                rows["cnt." + k])[k] for k, (m, m2) in std.items()}
        views = self.collect(state.position)
        if not self.draws:
            # allocated at the first draw (captured: the probe's), outside
            # any graph's pool
            self.draws.update({k: torch.empty(
                (v.shape[0], self.draws_len) + tuple(v.shape[1:]),
                dtype=v.dtype, device=v.device) for k, v in views.items()})
        col = rows["col"].reshape(1)
        for k, v in views.items():
            self.draws[k].index_copy_(1, col, v.unsqueeze(1))
        return {"state": _state_tree(state), "fold": fold, "std": std}

    def state(self) -> KernelState:
        return KernelState(**self.carry()["state"], t=self.t)

    def acc(self) -> tuple:
        """(std_acc, fold_acc) with the host counts."""
        carry = self.carry()
        return ({k: (self.counts["std"][k], m, m2)
                 for k, (m, m2) in carry["std"].items()},
                {k: (self.counts["fold"][k], m, m2)
                 for k, (m, m2) in carry["fold"].items()})


def state_device(state: KernelState) -> torch.device:
    return next(iter(state.position.values())).device
