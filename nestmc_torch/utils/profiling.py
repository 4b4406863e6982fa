"""Profiling helpers: port of :mod:`nestmc.utils.profiling`.

- ``trace(directory)``: torch.profiler over a block, its Chrome trace
  written to the directory (the command line's ``--profile DIR``);
  :func:`add_track` adds a finished call's device-timed spans to it as a
  track of their own.
- ``span(name)``: a labelled region, the one span system of the port
  (below).
- ``sweep_cost``: the cost of one sweep, below.

Spans. ``span(name)`` is a ``torch.profiler.record_function`` named
``nestmc.<name>`` (the engine's ``nestmc.warmup.seg{i}`` and
``nestmc.sample.seg{i}``, as the reference's; the segment programs'
``nestmc.segment.*`` and ``nestmc.capture.*``; the engine's
``nestmc.finalize``), so trace reductions treat its device mirror as an
annotation. While a :class:`Spans` recorder is armed (:data:`RECORDER`,
set by :func:`recording` around a step of a program that records spans:
``engine.sample(..., spans=True)``'s draw step), the span is also timed
where its work runs: its entry and exit each write a stamp into the
program's stamp table, an int64 (steps, slots) tensor allocated once
when the recorder is made, at the row of the program's step counter. On
the card a stamp is a one-thread kernel (csrc/span_mark.cu) that writes
``%globaltimer``, so a captured step's marks are nodes of its graph and
every replay writes its own row with no host step between replays; on
the CPU it is the host's ``time.perf_counter_ns``. Slots are given out in
the order the step records them (at capture, for a graph); a span opened
right after its previous sibling closed shares that sibling's exit mark,
and work issued between two siblings counts in the second. Each span's
record holds its name, its parent, the sweep of its step it belongs to
(the spans inside the k-th ``sweep`` span share index k), its two slots
and the counts taken inside it as it was recorded: hand-written kernel
launches (ops/cuda.LAUNCHES) and ``groups_sum`` calls (collectives.STATS).
Disarmed, a span costs one global read besides the record_function: no
mark is launched or captured, no table allocated and nothing copied to
the host.

The cost of one sweep: port of :func:`nestmc.utils.profiling.sweep_cost`.

The reference compiles one sweep and reads XLA's cost model. Eager
PyTorch has none, so the port counts one ``adapt=False`` sweep as it runs
(:func:`count_sweep`), in two parts:

- **Kernels.** Every kernel wrapper (ops/cuda/*, ``costed``) records its
  launch (kernel, C, U, n, p, noise, fold), and :func:`kernel_work` gives
  its bytes and float32 operations: each input read once and each output
  written once, and the operations of its algebra. The same function
  gives the bound that ``chip_smoke.py`` prints for every kernel, so the
  bound and the cost model cannot drift apart.
- **Plain PyTorch between the kernels**, counted by a
  ``TorchDispatchMode`` on every aten op: flops from
  ``torch.utils.flop_counter``'s registered formula where it has one (mm,
  bmm, addmm, baddbmm: 2 a multiply-add), else one a output element (a
  floor for transcendentals and for linalg ops such as a Cholesky
  factor, which have no formula there); bytes as the op's tensor inputs
  and outputs, an unfused upper bound (each op reads and writes memory
  where a fused kernel would keep its intermediates in registers). View
  and allocation ops count nothing.

The count pauses inside a kernel wrapper, so a wrapper's plain version on
the CPU counts as its kernel's :func:`kernel_work`, not as its aten ops:
the CPU and the card count the same work for the same shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from nestmc_torch.ops.cuda import LAUNCHES, _build
from nestmc_torch.parallel.collectives import STATS

@contextlib.contextmanager
def trace(directory: str, name: str = "trace", cuda: bool | None = None):
    """torch.profiler over the block (CPU ops, and the card's kernels when
    ``cuda``, by default when a card is present); at exit its Chrome trace
    is written to ``directory/name.trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(trace_path(directory, name))


def trace_path(directory: str, name: str = "trace") -> str:
    """Where :func:`trace` writes its trace."""
    return os.path.join(directory, f"{name}.trace.json")


def add_track(path: str, events: list) -> None:
    """Insert the spans ``events`` [(name, start ns, end ns, args)], on
    the profiler's clock (Unix ns; :meth:`Spans.events`), at the head of the traceEvents of the
    Chrome trace at ``path`` as the track 'nestmc spans (device)' (into
    the text: a whole run's trace is too large to decode and encode
    again)."""
    with open(path) as f:
        text = f.read()
    m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', text)
    base = int(m.group(1)) if m else 0
    pid = "nestmc spans (device)"
    items = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
              "args": {"name": pid}}]
    items += [{"name": "nestmc." + name, "ph": "X", "cat": "span",
               "pid": pid, "tid": 0, "ts": (t0 - base) / 1e3,
               "dur": (t1 - t0) / 1e3, "args": args}
              for name, t0, t1, args in events]
    at = re.search(r'"traceEvents"\s*:\s*\[', text).end()
    sep = "" if text[at:].lstrip().startswith("]") else ","
    with open(path, "w") as f:
        f.write(text[:at] + ",".join(map(json.dumps, items)) + sep
                + text[at:])


# the armed span recorder (a program's Spans while a step of it records),
# else None: a disarmed span reads this one global
RECORDER = None
# the span of one sweep: the spans inside the k-th of a step share index k
SWEEP = "sweep"
# the stamp table's slots a sweep (at most two marks a span: the sweep's
# and those of up to 31 blocks and joint moves) and a step's own (the step,
# the streamed update, the collection, the copy back)
SLOTS_PER_SWEEP = 64
SLOTS_PER_STEP = 16


@contextlib.contextmanager
def span(name: str):
    """A labelled region: the profiler span ``nestmc.<name>`` and, while a
    recorder is armed, a device-timed span of its program (the module's
    notes)."""
    rec = RECORDER
    with torch.profiler.record_function("nestmc." + name):
        if rec is None:
            yield
            return
        rec.enter(name)
        try:
            yield
        finally:
            rec.exit()


@contextlib.contextmanager
def recording(rec, variant):
    """Arm ``rec`` (a :class:`Spans`, or None: nothing) for one step of
    its program, the step's variant ``variant``."""
    global RECORDER
    if rec is None:
        yield
        return
    rec.begin()
    RECORDER = rec
    try:
        yield
    finally:
        RECORDER = None
    rec.end(variant)


def span_role(name: str, unit_blocks) -> str:
    """The role of span ``name``: a block whose name is in
    ``unit_blocks`` (the model's unit_axes) is a unit block, every other
    block a population block; ``move.*`` a joint move; ``step.copy_back``
    the copy back; the rest (the step, the sweep, the streamed R-hat
    update, the collection) rest."""
    if name.startswith("block."):
        return ("unit block" if name[len("block."):] in unit_blocks
                else "population block")
    if name.startswith("move."):
        return "joint move"
    return "copy back" if name == "step.copy_back" else "rest"


def clock_offset(device, tries: int = 8) -> dict:
    """{'offset_ns', 'uncertainty_ns'}: the ns to add to a stamp of
    ``device`` (the card's %globaltimer; the CPU's perf_counter_ns) to put
    it on the clock torch.profiler stamps its events with (Unix time,
    time.time_ns), from the tightest of ``tries`` host readings around one
    synchronised mark: the mark ran between them, the offset is taken at
    their middle and the uncertainty is half their distance."""
    device = torch.device(device)
    best = None
    if device.type == "cuda":
        lib = _build.shared_library()
        table = torch.zeros(1, dtype=torch.long, device=device)
        row = torch.zeros(1, dtype=torch.long, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(tries):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            h0 = time.time_ns()
            _build.check(lib.nestmc_span_mark(table.data_ptr(),
                                              row.data_ptr(), 0, 1, 1,
                                              stream), "span_mark")
            torch.cuda.synchronize(device)
            h1 = time.time_ns()
            stamp = int(table.item())
        else:
            h0 = time.time_ns()
            stamp = time.perf_counter_ns()
            h1 = time.time_ns()
        if best is None or h1 - h0 < best[1]:
            best = ((h0 + h1) // 2 - stamp, h1 - h0)
    return {"offset_ns": int(best[0]), "uncertainty_ns": best[1] / 2}


@dataclasses.dataclass
class SpanRecord:
    """One span of a recorded step: its name, its parent's index in the
    step's records (None for the root), the sweep of the step it belongs
    to (None outside every sweep), the slots of its entry and exit marks,
    and the hand-written kernel launches and groups_sum calls taken inside
    it as it was recorded."""
    name: str
    parent: int | None
    sweep: int | None
    start: int
    end: int = -1
    launches: int = 0
    groups_sum: int = 0


class Spans:
    """The device-timed spans of one program's steps (segments._Program
    with spans on): the stamp table of ``rows`` steps (the program's
    segment capacity) of ``sweeps`` sweeps each, read at ``counter``, the
    program's step counter (a (1,) long tensor on ``device``); the records
    of each step variant, as its first step (its capture, for a graph)
    recorded them; the rows read after each segment; and the offset of
    the stamps from the profiler's clock (:func:`clock_offset`), measured
    when the recorder is made. The table is allocated here, before any
    capture, at SLOTS_PER_SWEEP slots a sweep and SLOTS_PER_STEP more; a
    step that makes more marks raises."""

    def __init__(self, device, rows: int, sweeps: int,
                 counter: torch.Tensor):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rows = rows
        self.counter = counter
        self.width = SLOTS_PER_SWEEP * sweeps + SLOTS_PER_STEP
        self.table = torch.zeros(rows, self.width, dtype=torch.long,
                                 device=self.device)
        self.layouts = {}           # {variant: [SpanRecord, ...]}
        self.slots = {}             # {variant: marks a step}
        self.segments = []          # [(variants, (n, width) int64 host)]
        self.clock = clock_offset(self.device)

    # ---- recording one step ----
    def begin(self) -> None:
        self._records, self._stack, self._slot = [], [], 0
        self._sweep = -1
        self._prev = None           # (depth, slot) of the last exit
        self._host = []             # CPU: this step's stamps, by slot

    def enter(self, name: str) -> None:
        depth = len(self._stack)
        parent = self._stack[-1][0] if self._stack else None
        if name == SWEEP:
            self._sweep += 1
            sweep = self._sweep
        else:
            sweep = None if parent is None else self._records[parent].sweep
        if self._prev is not None and self._prev[0] == depth:
            start = self._prev[1]
        else:
            start = self._mark()
        self._records.append(SpanRecord(name, parent, sweep, start))
        self._stack.append((len(self._records) - 1, sum(LAUNCHES.values()),
                            STATS["groups_sum_calls"]))
        self._prev = None

    def exit(self) -> None:
        i, launches, calls = self._stack.pop()
        rec = self._records[i]
        rec.end = self._mark()
        rec.launches = sum(LAUNCHES.values()) - launches
        rec.groups_sum = STATS["groups_sum_calls"] - calls
        self._prev = (len(self._stack), rec.end)

    def _mark(self) -> int:
        slot = self._slot
        if slot >= self.width:
            raise RuntimeError(f"a step made more than {self.width} span "
                               f"marks, the stamp table's width")
        self._slot += 1
        if self.cuda:
            _build.check(_build.shared_library().nestmc_span_mark(
                self.table.data_ptr(), self.counter.data_ptr(), slot,
                self.width, self.rows,
                torch.cuda.current_stream(self.device).cuda_stream),
                "span_mark")
        else:
            self._host.append(time.perf_counter_ns())
        return slot

    def end(self, variant) -> None:
        """Close a step: keep its records as its variant's (the first
        step's), and on the CPU write its stamps into its row."""
        n = self._slot
        if variant not in self.layouts:
            self.layouts[variant], self.slots[variant] = self._records, n
        elif self.slots[variant] != n:
            raise RuntimeError(f"a step of variant {variant!r} made {n} "
                               f"span marks, its first "
                               f"{self.slots[variant]}")
        if not self.cuda:
            self.table[int(self.counter), :n] = torch.tensor(self._host)

    def read(self, variants: list) -> None:
        """Copy the stamps of a segment's steps (its variants in order) to
        the host and clear their rows, in stream order: on the card into
        pinned memory without waiting, so the host goes on to the next
        segment while the replays run (the rows are read after the call's
        closing synchronise)."""
        if not variants:
            return
        n = len(variants)
        rows = torch.empty((n, self.width), dtype=torch.long,
                           pin_memory=self.cuda)
        rows.copy_(self.table[:n], non_blocking=self.cuda)
        self.table[:n].zero_()
        self.segments.append((list(variants), rows))

    # ---- what the rows read ----
    def _steps(self):
        """(records, stamps) of each step read."""
        for variants, rows in self.segments:
            for v, row in zip(variants, rows.numpy()):
                yield self.layouts[v], row

    def summary(self, unit_blocks, thin: int) -> dict:
        """{span name: its parent's name, role (:func:`span_role`), the
        mean, median and 90th-percentile ms a sweep, the mean self ms a
        sweep (its time less its children's), the hand-written launches
        and groups_sum calls a sweep, and the sweeps read}, over the steps
        read, each step's time over its ``thin`` sweeps; a span that a
        step's variant lacks counts 0 in that step."""
        names = {}
        for recs in self.layouts.values():
            for r in recs:
                if r.name not in names:
                    names[r.name] = (None if r.parent is None
                                     else recs[r.parent].name)
        index = {k: i for i, k in enumerate(names)}
        dur, own, cnt = [], [], []
        for recs, row in self._steps():
            d = np.zeros(len(names))
            s = np.zeros(len(names))
            c = np.zeros((len(names), 2))
            times = [int(row[r.end]) - int(row[r.start]) for r in recs]
            selfs = list(times)
            for r, t in zip(recs, times):
                if r.parent is not None:
                    selfs[r.parent] -= t
            for r, t, st in zip(recs, times, selfs):
                j = index[r.name]
                d[j] += t
                s[j] += st
                c[j] += (r.launches, r.groups_sum)
            dur.append(d)
            own.append(s)
            cnt.append(c)
        if not dur:
            return {}
        dur = np.stack(dur) / (1e6 * thin)
        own = np.stack(own) / (1e6 * thin)
        cnt = np.stack(cnt).mean(axis=0) / thin
        out = {}
        for name, j in index.items():
            col = dur[:, j]
            out[name] = {
                "parent": names[name], "role": span_role(name, unit_blocks),
                "mean_ms": float(col.mean()),
                "median_ms": float(np.median(col)),
                "p90_ms": float(np.percentile(col, 90)),
                "self_ms": float(own[:, j].mean()),
                "launches": float(cnt[j, 0]),
                "groups_sum": float(cnt[j, 1]),
                "sweeps": int(len(col) * thin)}
        return out

    def events(self) -> list:
        """[(name, start ns, end ns, args)] of every span of every step
        read, on the profiler's clock."""
        off = self.clock["offset_ns"]
        out = []
        step = 0
        for recs, row in self._steps():
            for r in recs:
                out.append((r.name, int(row[r.start]) + off,
                            int(row[r.end]) + off,
                            {"step": step, "sweep": r.sweep}))
            step += 1
        return out


# NVIDIA H100 80GB HBM3 (SXM), 700 W power limit: HBM3 memory rate and
# float32 rate outside the tensor cores, from the data sheet
HBM_BPS = 3.35e12
FP32_OPS = 67e12


def kernel_work(kernel: str, C: int, G: int, n: int, p: int,
                noise: bool = True, fold: bool = False) -> tuple:
    """(bytes, float32 operations) one call of ``kernel`` (a LAUNCHES key
    of ops/cuda) needs: each input read and each output written once; per
    obs-cell 2p (eta) + 9 (logistic value terms: exp, log1p, ...) or 5
    (Poisson: one exp) [+ 2p + 8 or 2p + 2 (gradient terms)] [+ 3T
    (Hessian; +1 for the Poisson mask)] operations, per cell the step's
    own algebra. G counts the units (groups, or subjects for pois_*).
    For the segment kernels (seg_*) ``n`` is the total number of
    observations N: they read x (N, p), y (N,) and the (G+1) row pointer,
    and evaluate C x N obs-cells. noise: the step reads external noise
    (eps, log u) instead of drawing Philox noise; fold: it folds the
    R-hat accumulators (2, G, p, C). For the noise fill (philox_fill)
    C x G is the block's rows x their elements and ``n`` the float32
    operations of an element's conversion (ops/cuda/philox_fill.FLOAT_OPS);
    it writes 4 bytes an element and reads two key words. Its Philox
    rounds (one call a quad of four elements) are integer instructions,
    which the float32 rate does not bound."""
    if kernel == "philox_fill":
        return 4 * C * G + 8, C * G * n
    if kernel.startswith("seg_"):
        val_ops = 2 * p + 9
        data = 4 * n * (p + 1) + 4 * (G + 1)
        if kernel == "seg_loglik":
            return data + 4 * C * G * (p + 1), C * n * val_ops
        return (data + 4 * C * G * (2 * p + 1),
                C * n * (val_ops + 2 * p + 8))
    pois = kernel.startswith("pois_")
    kernel = kernel[len("pois_"):] if pois else kernel
    T = p * (p + 1) // 2
    cells, obs = C * G, C * G * n
    data = 4 * G * n * (p + 2) + (4 * G if pois else 0)
    # the prior mean and log tau: mu and log tau (C, p), or per unit
    hyper = 4 * C * p + (4 * cells * p if pois else 4 * C * p)
    f = 4 * 2 * G * p * C if fold else 0          # one (2, G, p, C) array
    nz = 4 * cells * (p + 1) if noise else 0
    val_ops = 2 * p + (5 if pois else 9)
    grad_ops = val_ops + 2 * p + (2 if pois else 8)
    hess_ops = 3 * T + (1 if pois else 0)
    if kernel == "loglik":
        return data + 4 * cells * (p + 1), obs * val_ops
    if kernel == "logp_grad":
        return data + 4 * cells * (2 * p + 1), obs * grad_ops
    if kernel == "logp_grad_hess":
        return (data + 4 * cells * (2 * p + 1 + T),
                obs * (grad_ops + hess_ops))
    if kernel == "rwmh_step":
        return (data + hyper + nz + 4 * cells * (2 * p + 4),
                obs * val_ops + cells * (8 * p + 6))
    if kernel == "mala_step":
        return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4),
                obs * grad_ops + cells * (16 * p + 12 + (8 * p if fold
                                                          else 0)))
    frozen = kernel == "newton_step_frozen"
    h = 0 if frozen else 4 * cells * T
    return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4 + T) + h,
            obs * (grad_ops + (0 if frozen else hess_ops))
            + cells * (4 * p ** 3 + 30 * p + (8 * p if fold else 0)))


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for work of ``nbytes`` and ``ops`` float32 operations, the larger of
    the two over HBM_BPS and FP32_OPS."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _no_work(func) -> bool:
    """Ops that move no data: views, allocations, scalar reads."""
    name = func._overloadpacket.__name__
    return (func.is_view or name.startswith(("empty", "new_empty"))
            or name in ("detach", "lift_fresh", "_local_scalar_dense",
                        "alias", "_unsafe_view", "set_"))


class _Counter(TorchDispatchMode):
    """Counts the aten ops of plain PyTorch while active, and records the
    kernel wrappers' launches (ops/cuda.costed calls :meth:`kernel`)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = self.bytes = 0
        self.launches = []
        self.paused = 0

    @contextlib.contextmanager
    def kernel(self, record):
        if not self.paused:
            self.launches.append(record)
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or _no_work(func):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if torch.is_tensor(t)]
        outs = [t for t in tree_flatten(out)[0] if torch.is_tensor(t)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        else:
            self.flops += sum(t.numel() for t in outs)
        return out


def count_sweep(model, data, cfg, chains: int | None = None) -> dict:
    """Count one ``adapt=False`` sweep (kernels/gibbs.make_sweep) from a
    fresh init_kernel_state (seed 0) on the data's device, unsharded:
    {'launches': [(kernel, C, U, n, p, noise, fold), ...],
    'kernel_bytes', 'kernel_flops' (kernel_work summed over the
    launches), 'plain_bytes', 'plain_flops' (the aten ops between them)}.
    chains: overrides cfg.run.chains."""
    from nestmc_torch.config import ShardingConfig
    from nestmc_torch.data import data_device
    from nestmc_torch.kernels.gibbs import make_sweep
    from nestmc_torch.kernels.state import init_kernel_state
    from nestmc_torch.ops import cuda
    from nestmc_torch.rng import SweepRNG

    run = cfg.run if chains is None else dataclasses.replace(
        cfg.run, chains=chains)
    cfg = dataclasses.replace(cfg, run=run, sharding=ShardingConfig())
    rng = SweepRNG(0, data_device(data))
    state = init_kernel_state(model, cfg, rng, data)
    sweep = make_sweep(model, cfg)
    counter = _Counter()
    prev, cuda.RECORDER = cuda.RECORDER, counter
    try:
        with counter:
            sweep(state, data, False, rng)
    finally:
        cuda.RECORDER = prev
    work = [kernel_work(*rec) for rec in counter.launches]
    return {"launches": counter.launches,
            "kernel_bytes": sum(b for b, _ in work),
            "kernel_flops": sum(f for _, f in work),
            "plain_bytes": counter.bytes, "plain_flops": counter.flops}


def sweep_cost(model, data, cfg, chains: int | None = None) -> dict:
    """The reference's keys for one sweep (:func:`count_sweep`):
    flops_per_sweep, bytes_per_sweep, flops_per_sweep_per_chain,
    arithmetic_intensity (flops a byte) and sol_sweeps_per_sec_hbm (the
    sweeps a second the H100's memory rate allows at these bytes)."""
    c = count_sweep(model, data, cfg, chains)
    flops = float(c["kernel_flops"] + c["plain_flops"])
    by = float(c["kernel_bytes"] + c["plain_bytes"])
    n = chains if chains is not None else cfg.run.chains
    out = {
        "flops_per_sweep": flops,
        "bytes_per_sweep": by,
        "flops_per_sweep_per_chain": flops / max(n, 1),
        "arithmetic_intensity": flops / by if by else None,
    }
    if by:
        out["sol_sweeps_per_sec_hbm"] = HBM_BPS / by
    return out
