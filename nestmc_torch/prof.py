"""Where a sweep's time goes: ``python -m nestmc_torch.prof``.

Profiles the judged config of :mod:`nestmc_torch.bench` (1024 chains,
G=1000 groups x n=50 obs, p=4) on one CUDA device, sweep by sweep, in both
phases: warmup (refreshed metric) and sampling (frozen metric, with the
streamed R-hat fold the engine passes). For each phase it reports, per
sweep:

- ``wall_ms``: untraced wall time, each of ``--repeats`` runs of
  ``--sweeps`` back-to-back sweeps synchronised only at its two ends;
- ``device_busy_ms``, ``device_kernels``, ``idle_share`` and ``ours_ms``
  (the port's own kernels), from torch.profiler over ``--sweeps`` sweeps:
  the sum and count of device kernel self-times, and 1 - busy / the
  median untraced wall;
- ``block_ms``: each block's time (the Newton beta step, each Gibbs draw,
  the interweaving move) with the device synchronised around every block;
- ``host_top``: the port's functions with the most cumulative host time
  (cProfile), in ms per sweep.

Prints one JSON object; ``--out`` also writes torch.profiler's tables.
``--device cpu`` with small ``--chains/--groups`` runs the same code on the
CPU, where the device fields are null.
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

from nestmc_torch.bench import JUDGED, gpu_query, judged_config
from nestmc_torch.diagnostics import fold_rhat_init, fold_rhat_scalars
from nestmc_torch.kernels.gibbs import make_sweep, rhat_fold_names
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.rng import SweepRNG


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Phase:
    """Runs sweeps of one phase from a state, carrying the fold
    accumulators as the engine does in sampling."""

    def __init__(self, model, cfg, data, rng, state, adapt: bool):
        self.sweep = make_sweep(model, cfg)
        self.data, self.rng, self.state, self.adapt = data, rng, state, adapt
        self.names = () if adapt else rhat_fold_names(model, cfg)
        self.acc = fold_rhat_init(state.position, self.names)
        self.j = 0

    def step(self) -> None:
        if not self.names:
            self.state = self.sweep(self.state, self.data, self.adapt,
                                    self.rng)
            return
        # an always-active fold in the first half, as early in sampling
        scs = {k: fold_rhat_scalars(self.acc[k][0], self.j, 1 << 30)
               for k in self.names}
        folds = {k: (self.acc[k][1], self.acc[k][2], scs[k])
                 for k in self.names}
        self.state, fout = self.sweep(self.state, self.data, False, self.rng,
                                      folds)
        self.acc = {k: (self.acc[k][0] + scs[k][:, 1], *fout[k])
                    for k in self.names}
        self.j += 1


def _timed_hooks(model, device, totals: dict):
    """A copy of ``model`` whose per-block functions add their synced
    seconds to ``totals``; signatures are kept (make_sweep reads them)."""

    def wrap(label, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            totals[label] = totals.get(label, 0.0) + time.perf_counter() - t0
            return out
        return timed

    return dataclasses.replace(
        model,
        gibbs_draws={k: wrap(f"gibbs {k}", f)
                     for k, f in model.gibbs_draws.items()},
        fused_updates_newton={k: wrap(f"newton {k}", f)
                              for k, f in model.fused_updates_newton.items()},
        joint_moves={k: wrap(f"move {k}", f)
                     for k, f in model.joint_moves.items()},
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
        for _ in range(sweeps):
            phase.step()
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
    for _ in range(sweeps):
        phase.step()
    _sync(device)
    prof.disable()
    rows = []
    for (fname, line, func), (_, _, _, ct, _) in pstats.Stats(prof).stats.items():
        if "nestmc_torch" in fname and not fname.endswith("prof.py"):
            rel = fname[fname.rindex("nestmc_torch"):]
            rows.append((ct, f"{rel}:{line}:{func}"))
    rows.sort(reverse=True)
    return {name: ct * 1e3 / sweeps for ct, name in rows[:top]}


def profile_sweeps(chains: int = 1024, G: int = JUDGED["G"],
                   n: int = JUDGED["n"], p: int = JUDGED["p"],
                   sweeps: int = 20, repeats: int = 3, settle: int = 20,
                   device="cuda", out: str | None = None) -> dict:
    """Profile both phases of the judged sampler at the given size; returns
    the report dict (see the module docstring)."""
    device = torch.device(device)
    data, _ = synth_logistic(JUDGED["data_seed"], G=G, n=n, p=p,
                             device=device)
    model = make_hier_logistic(data, tau_prior="invgamma", asis_repeats=1)
    cfg = judged_config(chains, 0, 0)
    rng = SweepRNG(0, device)
    state = init_kernel_state(model, cfg, rng, data)
    warm = _Phase(model, cfg, data, rng, state, adapt=True)
    for _ in range(settle):
        warm.step()
    samp = _Phase(model, cfg, data, rng, warm.state, adapt=False)
    samp.step()

    report = {"device": str(device), "chains": chains, "G": G, "n": n,
              "p": p, "sweeps": sweeps, "repeats": repeats}
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
        report["nvidia_smi"] = gpu_query()
    tables = []
    for label, phase in (("warmup", warm), ("sampling", samp)):
        walls = []
        for _ in range(repeats):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(sweeps):
                phase.step()
            _sync(device)
            walls.append((time.perf_counter() - t0) * 1e3 / sweeps)
        busy, count, ours, avgs = _profile_phase(phase, sweeps, device)
        wall = statistics.median(walls)
        sort = "self_cpu_time_total"
        if device.type == "cuda":
            sort = ("self_device_time_total"
                    if hasattr(avgs[0], "self_device_time_total")
                    else "self_cuda_time_total")
        tables.append(f"== {label} ==\n"
                      + avgs.table(sort_by=sort, row_limit=30))

        totals = {}
        timed = _Phase(_timed_hooks(model, device, totals), cfg, data, rng,
                       phase.state, adapt=phase.adapt)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(sweeps):
            timed.step()
        _sync(device)
        synced = (time.perf_counter() - t0) * 1e3 / sweeps
        phase.state = timed.state

        report[label] = {
            "wall_ms": walls,
            "device_busy_ms": busy,
            "device_kernels": count,
            "idle_share": None if busy is None else 1.0 - busy / wall,
            "ours_ms": ours,
            "synced_sweep_ms": synced,
            "block_ms": {k: v * 1e3 / sweeps for k, v in totals.items()},
            "host_top": _host_top(phase, sweeps, device),
        }
    if out:
        with open(out, "w") as f:
            f.write("\n\n".join(tables) + "\n")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--groups", type=int, default=JUDGED["G"])
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="file for torch.profiler's tables")
    a = ap.parse_args(argv)
    report = profile_sweeps(chains=a.chains, G=a.groups, sweeps=a.sweeps,
                            repeats=a.repeats, device=a.device, out=a.out)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
