"""Where a sweep's time goes: ``python -m nestmc_torch.prof [--preset NAME]``.

Profiles a preset of :mod:`nestmc_torch.presets` (default the judged config:
1024 chains, G=1000 groups x n=50 obs, p=4; ``--preset mala-100k``: 512
chains, G=100,000 x 20, p=3) on one CUDA device, sweep by sweep, in both
phases: warmup (adapting; Newton's metric refreshed) and sampling (frozen,
with the streamed R-hat updates the engine makes: the in-kernel fold, or
the post-sweep update on every k-th draw at full_rhat_thin = k), each
through the engine's steps (segments.py), stepped eagerly and, on the
card, captured and replayed as the engine runs them. For each phase it
reports, per sweep:

- ``wall_ms``: untraced wall time of the eager steps, each of
  ``--repeats`` runs of ``--sweeps`` back-to-back sweeps synchronised only
  at its two ends; ``graph_wall_ms`` the same of the replayed graph;
- ``device_busy_ms``, ``device_kernels``, ``idle_share`` and ``ours_ms``
  (the port's own kernels), from torch.profiler over ``--sweeps`` eager
  sweeps: the sum and count of device kernel self-times, and 1 - busy /
  the median untraced wall; ``graph_device_busy_ms``,
  ``graph_device_kernels`` and ``graph_idle_share`` the same over
  ``--sweeps`` replays;
- ``block_ms``: each model hook's time (the fused beta step, each Gibbs
  draw, the unfused MH conditionals and the carried-cache obs passes of
  an unfused update, "lik NAME" and "prior NAME", the interweaving move)
  with the device synchronised around every call, in eager steps;
- ``host_top``: the port's functions with the most cumulative host time
  (cProfile), in ms per sweep;
- ``peak_mem_gb`` (CUDA): the most device memory allocated at once over
  the phase's sweeps (torch.cuda.max_memory_allocated).

Prints one JSON object; ``--out`` also writes torch.profiler's tables.
``--device cpu`` with small ``--chains/--groups`` runs the same code on the
CPU, where the device fields are null. ``--loglik-impl pallas-segment``
profiles a ragged preset (``--preset ragged-10k``, ``ragged-10k-mala``) on
its segment-kernel route; on ragged data ``n`` is the largest group's
size and ``N`` the number of observations.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import functools
import json
import pstats
import statistics
import time

import torch

from nestmc_torch.bench import gpu_query
from nestmc_torch.data import RaggedData
from nestmc_torch.diagnostics import fold_rhat_init, streaming_rhat_init
from nestmc_torch.kernels.gibbs import make_sweep, rhat_fold_names
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.presets import PRESETS, get_preset
from nestmc_torch.rng import SweepRNG
from nestmc_torch.segments import DrawProgram, WarmupProgram


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Phase:
    """One phase's engine steps (segments.py) from a state: adapting
    sweeps, or sampling draws with the engine's streamed R-hat updates
    (the fold in the first half, as early in sampling, or the post-sweep
    update of every rthin-th draw), collecting nothing; stepped eagerly or
    captured and replayed (``graph``)."""

    def __init__(self, model, cfg, data, rng, state, adapt: bool,
                 capacity: int, graph: bool = False):
        sweep = make_sweep(model, cfg)
        self.adapt = adapt
        if adapt:
            self.prog = WarmupProgram(sweep, state, data, rng, cfg, capacity,
                                      graph, None)
        else:
            names = rhat_fold_names(model, cfg)
            std = {}
            if cfg.run.full_rhat:
                std = streaming_rhat_init({
                    k: v for k, v in state.position.items()
                    if k not in names})
            self.prog = DrawProgram(
                sweep, state, data, rng, cfg, std,
                fold_rhat_init(state.position, names), lambda pos: {}, 0, 0,
                1 << 30, capacity, graph, None)
        self.j = 0

    @property
    def state(self):
        return self.prog.state()

    def run(self, n: int) -> None:
        """n steps (sweeps; a draw of thin sweeps in sampling)."""
        if self.adapt:
            self.prog.run(n)
        else:
            self.prog.run(n, self.j)
        self.j += n


def _walls(phase: _Phase, sweeps: int, repeats: int, device) -> list:
    """ms a sweep of ``repeats`` runs of ``sweeps`` steps, each synced at
    its ends only."""
    walls = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        phase.run(sweeps)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3 / sweeps)
    return walls


def _timed_hooks(model, device, totals: dict):
    """A copy of ``model`` whose hooks add their synced seconds to
    ``totals``; signatures are kept (make_sweep reads them)."""

    def wrap(label, fn):
        if fn is None:
            return None

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            key = label if label else f"cond {args[0]}"
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0
            return out
        return timed

    def table(prefix, hooks):
        return {k: wrap(f"{prefix} {k}", f) for k, f in hooks.items()}

    def cached(hooks):
        return {k: (wrap(f"lik {k}", f), wrap(f"prior {k}", r))
                for k, (f, r) in hooks.items()}

    return dataclasses.replace(
        model,
        gibbs_draws=table("gibbs", model.gibbs_draws),
        fused_updates=table("rwmh", model.fused_updates),
        fused_updates_mala=table("mala", model.fused_updates_mala),
        fused_updates_newton=table("newton", model.fused_updates_newton),
        joint_moves=table("move", model.joint_moves),
        cond_cached=cached(model.cond_cached),
        cond_cached_grad=cached(model.cond_cached_grad),
        cond_cached_newton=cached(model.cond_cached_newton),
        cond_logdensity=wrap(None, model.cond_logdensity),
        cond_value_and_grad=wrap(None, model.cond_value_and_grad),
    )


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _profile_phase(phase: _Phase, sweeps: int, device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        phase.run(sweeps)
        _sync(device)
    avgs = prof.key_averages()
    if device.type != "cuda":
        return None, None, None, avgs
    kern = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kern) / 1e3 / sweeps
    count = sum(e.count for e in kern) / sweeps
    ours = {}
    for e in kern:
        if "nestmc::" in e.key:
            name = e.key.split("nestmc::", 1)[1].split("(", 1)[0]
            ours[name] = ours.get(name, 0.0) + _device_us(e) / 1e3 / sweeps
    return busy, count, ours, avgs


def _host_top(phase: _Phase, sweeps: int, device, top: int = 12) -> dict:
    prof = cProfile.Profile()
    _sync(device)
    prof.enable()
    phase.run(sweeps)
    _sync(device)
    prof.disable()
    rows = []
    for (fname, line, func), (_, _, _, ct, _) in pstats.Stats(prof).stats.items():
        if "nestmc_torch" in fname and not fname.endswith("prof.py"):
            rel = fname[fname.rindex("nestmc_torch"):]
            rows.append((ct, f"{rel}:{line}:{func}"))
    rows.sort(reverse=True)
    return {name: ct * 1e3 / sweeps for ct, name in rows[:top]}


def profile_sweeps(preset: str = "judged", chains: int | None = None,
                   groups: int | None = None, sweeps: int = 20,
                   repeats: int = 3, settle: int = 20, device="cuda",
                   out: str | None = None,
                   loglik_impl: str = "auto") -> dict:
    """Profile both phases of a preset's sampler (its chains and groups
    unless given); returns the report dict (see the module docstring)."""
    device = torch.device(device)
    model, data, cfg = get_preset(preset, device=device, groups=groups,
                                  loglik_impl=loglik_impl)
    if chains is not None:
        cfg = dataclasses.replace(
            cfg, run=dataclasses.replace(cfg.run, chains=chains)
        )
    rng = SweepRNG(0, device)
    state = init_kernel_state(model, cfg, rng, data)
    cap = max(sweeps, settle)
    warm = _Phase(model, cfg, data, rng, state, True, cap)
    warm.run(settle)
    samp = _Phase(model, cfg, data, rng, warm.state, False, cap)
    samp.run(1)

    report = {"preset": preset, "device": str(device),
              "loglik_impl": model.loglik_impls.get("selected"),
              "chains": cfg.run.chains, "G": data.num_groups,
              "p": data.num_covariates, "sweeps": sweeps,
              "repeats": repeats}
    if isinstance(data, RaggedData):
        report["N"] = data.num_obs
        report["n"] = int(data.sizes().max())
    else:
        report["n"] = data.x.shape[1]
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
        report["nvidia_smi"] = gpu_query()
    tables = []
    for label, phase in (("warmup", warm), ("sampling", samp)):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        walls = _walls(phase, sweeps, repeats, device)
        busy, count, ours, avgs = _profile_phase(phase, sweeps, device)
        wall = statistics.median(walls)
        g_walls = g_busy = g_count = None
        if device.type == "cuda":
            # the engine's loop: the same step captured, then replayed
            graph = _Phase(model, cfg, data, rng, phase.state, phase.adapt,
                           sweeps, graph=True)
            graph.j = phase.j
            graph.run(sweeps)
            g_walls = _walls(graph, sweeps, repeats, device)
            g_busy, g_count, _, _ = _profile_phase(graph, sweeps, device)
            phase.prog, phase.j = graph.prog, graph.j
            phase.prog.graph = False    # the synced readings step eagerly
            graph.prog.close()
        sort = "self_cpu_time_total"
        if device.type == "cuda":
            sort = ("self_device_time_total"
                    if hasattr(avgs[0], "self_device_time_total")
                    else "self_cuda_time_total")
        tables.append(f"== {label} ==\n"
                      + avgs.table(sort_by=sort, row_limit=30))

        totals = {}
        timed = _Phase(_timed_hooks(model, device, totals), cfg, data, rng,
                       phase.state, phase.adapt, sweeps)
        timed.j = phase.j
        _sync(device)
        t0 = time.perf_counter()
        timed.run(sweeps)
        _sync(device)
        synced = (time.perf_counter() - t0) * 1e3 / sweeps
        phase.prog, phase.j = timed.prog, timed.j

        report[label] = {
            "wall_ms": walls,
            "device_busy_ms": busy,
            "device_kernels": count,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "graph_wall_ms": g_walls,
            "graph_device_busy_ms": g_busy,
            "graph_device_kernels": g_count,
            "graph_idle_share": (None if g_busy is None else
                                 1.0 - g_busy / statistics.median(g_walls)),
            "ours_ms": ours,
            "synced_sweep_ms": synced,
            "block_ms": {k: v * 1e3 / sweeps for k, v in totals.items()},
            "host_top": _host_top(phase, sweeps, device),
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None),
        }
    if out:
        with open(out, "w") as f:
            f.write("\n\n".join(tables) + "\n")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="judged", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="file for torch.profiler's tables")
    ap.add_argument("--loglik-impl", default="auto",
                    choices=("auto", "bucket", "pallas-segment"),
                    help="obs-pass route of a ragged preset")
    a = ap.parse_args(argv)
    report = profile_sweeps(preset=a.preset, chains=a.chains,
                            groups=a.groups, sweeps=a.sweeps,
                            repeats=a.repeats, device=a.device, out=a.out,
                            loglik_impl=a.loglik_impl)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
