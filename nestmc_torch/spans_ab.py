"""Where a preset's draw step spends its time, by the program's own
device-timed spans with the profiler off, and what the spans cost.

    python -m nestmc_torch.spans_ab [--preset judged] [--seeds 1,2,3]
        [--draws 128] [--segment 64] [--pairs 12] [--pair-draws 512]
        [--ranks N] [--device cuda] [--scale 1.0] [--groups G]
        [--out FILE]

Each seed runs the preset (its data the preset's at seed 0; the seed
seeds the chains) through its warmup (engine.warmup_then_state), then one
``sample(..., spans=True)`` call of ``--draws`` draws in segments of
``--segment`` from the adapted carry, and prints a "split" line: the
call's ``sample_s``, the summed time of its steps (each from its entry
mark to its exit mark) and their coverage of ``sample_s``, the gaps
between consecutive steps (10th, 50th and 90th percentiles, ns), the
least step between two stamps (the device clock's tick as the stamps see
it), the stamps' offset from the profiler's clock (``spans_clock``), each
role's summed self ms a sweep (unit block, population block, joint move,
copy back, rest: they sum to the step's) and ``timings["spans"]``.

Then, from the first seed's carry, ``--pairs`` pairs of calls of
``--pair-draws`` draws in one process, spans on then off: an "alt" line a
call (ms a sweep, its ``sample_s`` over its sweeps; with spans on, the
coverage and, under ``span_ms``, each span's mean and 90th-percentile ms
a sweep, so calls that run at another speed show which spans moved), and
a last "cost" line: the median and quartiles (statistics.quantiles) of on
and off and the ratio of the medians.

--ranks N starts N processes of this command, rank r on card r over NCCL
(the preset shards as on N ranks: mala-100k 2 groups x 2 chains on four);
rank 0 prints. The lines go to stdout and, with --out, are appended to
FILE, after a line with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

ROLES = ("unit block", "population block", "joint move", "copy back",
         "rest")


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def by_role(spans: dict) -> dict:
    """The summed self ms a sweep of each role of ``timings['spans']``:
    they tile the step, so they sum to its mean."""
    out = dict.fromkeys(ROLES, 0.0)
    for v in spans.values():
        out[v["role"]] += v["self_ms"]
    return out


def steps(rec) -> dict:
    """Of a call's recorder (Posterior.spans): its steps' summed time (s),
    the gaps between consecutive steps and the least step between two
    stamps (ns)."""
    total, gaps, stamps, prev = 0, [], [], None
    for recs, row in rec._steps():
        root = recs[0]
        t0, t1 = int(row[root.start]), int(row[root.end])
        total += t1 - t0
        if prev is not None:
            gaps.append(t0 - prev)
        prev = t1
        stamps.append(row[:root.end + 1])
    tick = np.diff(np.unique(np.concatenate(stamps))) if stamps else []
    return {"steps_s": total / 1e9,
            "gap_ns": ([float(np.percentile(gaps, q)) for q in (10, 50, 90)]
                       if gaps else None),
            "tick_ns": int(tick.min()) if len(tick) else None}


def _run(args, emit) -> None:
    import torch

    from nestmc_torch.engine import sample, warmup_then_state
    from nestmc_torch.parallel import multihost
    from nestmc_torch.presets import get_preset
    from nestmc_torch.rng import SweepRNG

    dev = multihost.device() or torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def with_run(cfg, **kw):
        return dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                                **kw))

    model, data, cfg = get_preset(args.preset, 0, dev, scale=args.scale,
                                  groups=args.groups)
    thin = cfg.run.thin
    state = None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rng = SweepRNG(seed, dev)
        s0 = warmup_then_state(model, data, with_run(cfg, seed=seed), rng)
        sync()
        post = sample(model, data,
                      with_run(cfg, seed=seed, draws=args.draws,
                               segment_size=args.segment),
                      rng=rng, init_state=s0, skip_warmup=True, spans=True)
        sync()
        tm = post.timings
        st = steps(post.spans)
        emit({"kind": "split", "preset": args.preset, "seed": seed,
              "draws": args.draws, "segment": args.segment,
              "sample_s": tm["sample_s"], "capture_s": tm["capture_s"],
              **st, "coverage": st["steps_s"] / tm["sample_s"],
              "clock": tm["spans_clock"], "roles": by_role(tm["spans"]),
              "step_ms": tm["spans"]["step"]["mean_ms"],
              "spans": tm["spans"]})
        if i == 0:
            state, first = post.final_state, rng
        del post
    ms = {True: [], False: []}
    acfg = with_run(cfg, draws=args.pair_draws)
    for j in range(2 * args.pairs):
        on = j % 2 == 0
        post = sample(model, data, acfg, rng=first, init_state=state,
                      skip_warmup=True, spans=on)
        state = post.final_state
        tm = post.timings
        ms[on].append(1e3 * tm["sample_s"] / (args.pair_draws * thin))
        line = {"kind": "alt", "call": j, "spans": on,
                "ms_per_sweep": ms[on][-1], "capture_s": tm["capture_s"]}
        if on:
            line.update(
                coverage=steps(post.spans)["steps_s"] / tm["sample_s"],
                span_ms={k: [v["mean_ms"], v["p90_ms"]]
                         for k, v in tm["spans"].items()})
        emit(line)
        del post
    if args.pairs:
        quart = {k: statistics.quantiles(v, n=4) if len(v) > 1 else v * 3
                 for k, v in ms.items()}
        emit({"kind": "cost", "pairs": args.pairs,
              "on_ms": statistics.median(ms[True]),
              "on_quartiles": [quart[True][0], quart[True][2]],
              "off_ms": statistics.median(ms[False]),
              "off_quartiles": [quart[False][0], quart[False][2]],
              "ratio": statistics.median(ms[True])
              / statistics.median(ms[False])})
    if multihost.world_size() > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


def _launch(argv, ranks: int) -> int:
    """Start ``ranks`` processes of this command on one host, each its own
    rank over NCCL; the kernels are built once first."""
    from nestmc_torch.ops.cuda import _build

    _build.build([3, 4])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(ranks):
        env = dict(os.environ, NESTMC_COORDINATOR_ADDRESS=f"localhost:{port}",
                   NESTMC_NUM_PROCESSES=str(ranks), NESTMC_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nestmc_torch.spans_ab", *argv], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL))
    return max(p.wait() for p in procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="judged")
    ap.add_argument("--seeds", default="1,2,3",
                    help="comma-separated; one split line each")
    ap.add_argument("--draws", type=int, default=128)
    ap.add_argument("--segment", type=int, default=64)
    ap.add_argument("--pairs", type=int, default=12,
                    help="pairs of calls with spans on and off")
    ap.add_argument("--pair-draws", type=int, default=512)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink the preset (the command line's --scale)")
    ap.add_argument("--groups", type=int, default=None,
                    help="the preset's number of groups")
    ap.add_argument("--out", default=None, help="also append the lines here")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.ranks > 1 and "NESTMC_NUM_PROCESSES" not in os.environ:
        return _launch(argv, args.ranks)
    from nestmc_torch.parallel import multihost

    multihost.initialize()

    def emit(line):
        if multihost.rank() != 0:
            return
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    emit({"device": _smi() if args.device == "cuda" else args.device,
          "ranks": args.ranks, "at": time.strftime("%Y-%m-%dT%H:%M:%S")})
    _run(args, emit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
