"""The traced stretch: torch.profiler (CPU and CUDA) over a bounded run of
the program's replayed sampling step, reduced to what the per-layer
metrics read.

The stretch is the device time spanned by the kernels of the replayed
CUDA graphs (the device operations whose correlation id is that of a
``cudaGraphLaunch`` call): from the start of the first such kernel to the
end of the last. The capture and its eager probe run before it, the
streamed R-hat's finalize after it, so neither is in the stretch. Within
it, a device operation is a kernel, a copy or a fill (the profiler's
annotations mirrored onto the device timeline are not work); the device is
busy where one runs.
"""

from __future__ import annotations

import dataclasses

from portbench import roofline

_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Event:
    name: str
    device: bool
    start: int              # ns
    end: int                # ns
    corr: int
    kind: str               # the profiler's activity type


@dataclasses.dataclass
class Summary:
    """What a traced stretch reads: its length and busy time (s), the
    sweeps it holds, and per category ('kernels', 'plain', 'nccl') the
    device seconds and the operations launched; the hand-written kernels'
    summed bounds (s) and times (s) where counted; the top device
    operations and the longest idle gaps, each [name, seconds]."""
    stretch_s: float
    busy_s: float
    sweeps: int
    seconds: dict
    launches: dict
    bound_s: float
    counted_s: float
    device_ops: list
    idle_gaps: list


def _kind(e, device: bool) -> str:
    """The event's kind ('kernel', 'gpu_memcpy', 'gpu_memset',
    'gpu_user_annotation', 'cuda_runtime', 'cpu_op', ...), worked out from
    its name and whether it is a user annotation: this PyTorch's kineto
    events do not carry their activity type."""
    if e.is_user_annotation():
        return "gpu_user_annotation" if device else "user_annotation"
    name = e.name()
    if not device:
        return "cuda_runtime" if name.startswith("cuda") else "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def events_of(prof) -> list:
    """The profiler's raw events as :class:`Event` records. A device event
    named as a host annotation is that annotation mirrored onto the device
    timeline, not work."""
    raw = list(prof.profiler.kineto_results.events())
    out = []
    for e in raw:
        dev = "CUDA" in str(e.device_type())
        out.append(Event(e.name(), dev, int(e.start_ns()), int(e.end_ns()),
                         int(e.correlation_id()), _kind(e, dev)))
    spans = {e.name for e in out if not e.device
             and e.kind == "user_annotation"}
    for e in out:
        if e.device and (e.name in spans or e.name.startswith("nestmc.")):
            e.kind = "gpu_user_annotation"
    return out


def _union(intervals) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events: list, sweeps_per_replay: int, work=None,
              extra=()) -> Summary | None:
    """The stretch of ``events`` (see the module); None when no replayed
    kernel ran. ``work(name, ordinal)``: (bytes, operations) of a
    hand-written kernel's launch, the ordinal-th (from 0) of its name in
    its sweep, or None where it is not counted (the model's
    ``launch_work`` at this process's shapes); ``extra``: the model's own
    hand-written kernel names (roofline.classify)."""
    launches = {e.corr for e in events
                if not e.device and "GraphLaunch" in e.name}
    device_work = [e for e in events
                   if e.device and e.kind in _DEVICE_WORK]
    replayed = [e for e in device_work if e.corr in launches]
    if not replayed:
        return None
    t0 = min(e.start for e in replayed)
    t1 = max(e.end for e in replayed)
    inside = sorted((e for e in device_work
                     if e.start >= t0 and e.end <= t1),
                    key=lambda e: e.start)
    seconds = {"kernels": 0.0, "plain": 0.0, "nccl": 0.0}
    counts = {"kernels": 0, "plain": 0, "nccl": 0}
    by_name = {}
    cats = [roofline.classify(e.name, extra) for e in inside]
    # launches of each name in each replay: a replay holds
    # sweeps_per_replay sweeps
    per_replay = {}
    for e, cat in zip(inside, cats):
        if cat == "kernels":
            per_replay[e.corr, e.name] = per_replay.get((e.corr, e.name),
                                                        0) + 1
    seen = {}
    bound = counted = 0.0
    for e, cat in zip(inside, cats):
        dt = (e.end - e.start) * 1e-9
        seconds[cat] += dt
        counts[cat] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
        if cat == "kernels" and work is not None:
            key = (e.corr, e.name)
            i = seen.get(key, 0)
            seen[key] = i + 1
            per_sweep = max(1, per_replay[key] // sweeps_per_replay)
            w = work(e.name, i % per_sweep)
            if w is not None:
                bound += roofline.bound_ms(*w) * 1e-3
                counted += dt
    busy = _union((e.start, e.end) for e in inside)
    gaps, last = [], t0
    for e in inside:
        if e.start > last:
            gaps.append((e.start - last, last))
        last = max(last, e.end)
    host = [e for e in events if not e.device and e.kind != "python_function"]
    named = []
    for length, at in sorted(gaps, reverse=True)[:10]:
        doing = [h for h in host if h.start <= at < h.end]
        label = (min(doing, key=lambda h: h.end - h.start).name
                 if doing else "(host idle)")
        named.append([label, length * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Summary(
        stretch_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
        sweeps=len(launches) * sweeps_per_replay, seconds=seconds,
        launches=counts, bound_s=bound, counted_s=counted,
        device_ops=[[n[:160], s] for n, s in top], idle_gaps=named)


def profile(fn):
    """Run ``fn()`` under torch.profiler (CPU and CUDA), synchronised at its
    end; returns the raw events."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return events_of(prof)
