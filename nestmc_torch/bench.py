"""The benchmark on one GPU: ``python -m nestmc_torch.bench [--preset NAME]``.

Port of the repo's bench.py. The default preset, ``judged``, is bench.py's
config: the 1k-group hierarchical logistic model (G=1000 groups x n=50 obs,
p=4), 1024 chains, 1500 warmup sweeps and 4096 retained draws,
frozen-metric Newton-MH with the fused step, the inverse-gamma tau prior,
streamed split R-hat over all 4008 parameters. ``--preset NAME`` runs
any other name of nestmc_torch/presets.py: ``eight-schools`` (config 1: 4
chains, 1000/10,000, RW-MH, plain PyTorch); ``hier-logistic-100`` (config
2: G=100, n=50, p=4, 64 chains, 1500/4096, frozen-metric Newton-MH, R-hat
over all 408 parameters) and its RW-MH state ``hier-logistic-100-rw``;
``hier-logistic-1k`` (and ``-mala``: G=1000, 256 chains, 1000/2048);
``nested-poisson-1k`` (config 3: G=1000 groups x 4 subjects x 10 obs,
p=3, 512 chains, 1000/16384, RW-MH on the subjects, R-hat over all 15,009
parameters; ``-mala`` and ``-newton`` change the subject update);
``ragged-10k`` (config 4: G=10,000 ragged groups of 5..30 obs, p=3, 1024
chains, 800/2048, Newton-MH per size bucket, R-hat over all 30,006
parameters; ``-mala`` for MALA); ``mala-100k`` (config 5: G=100,000,
n=20, p=3, 512 chains, MALA, half-normal tau, R-hat streamed on every 4th
draw over all 300,006 parameters) and ``mala-100k-newton`` (its data,
frozen-metric Newton-MH, 1500/8192). ``--seed`` picks the run's seed (the
data and the chains; default 0).

Prints one JSON line with bench.py's fields; ``value`` is the sum of bulk
ESS over the collected scalars (judged: mu 4 + log_tau 4 + the first 8
groups' beta 32) per sampling second per GPU. Warmup is excluded from the
denominator. The run is rejected (exit 1) unless the worst R-hat over all
parameters is below 1.01. ``vs_baseline`` is null: the repo's 125k
ESS/s/chip north star was set for TPU chips. It needs a CUDA device.

Environment overrides: NESTMC_BENCH_CHAINS_PER_CHIP, NESTMC_BENCH_WARMUP,
NESTMC_BENCH_DRAWS.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

from nestmc_torch.data import data_device
from nestmc_torch.engine import sample
from nestmc_torch.parallel.sharding import gather_rates
from nestmc_torch.presets import PRESETS, get_preset

TITLES = {
    "eight-schools": "8-schools hierarchical normal, RW-MH",
    "hier-logistic-100": "100-group hierarchical logistic, Newton-MH",
    "hier-logistic-100-newton": "100-group hierarchical logistic, Newton-MH",
    "hier-logistic-100-rw": "100-group hierarchical logistic, RW-MH",
    "hier-logistic-1k": "1k-group hierarchical logistic, 256 chains",
    "hier-logistic-1k-newton": "1k-group hierarchical logistic, 256 chains",
    "hier-logistic-1k-mala":
        "1k-group hierarchical logistic, 256 chains, MALA",
    "judged": "1k-group hierarchical logistic",
    "mala-100k": "100k-group hierarchical logistic, MALA",
    "mala-100k-newton": "100k-group hierarchical logistic, Newton-MH",
    "nested-poisson-1k": "3-level nested Poisson GLMM, 1k groups",
    "nested-poisson-1k-mala": "3-level nested Poisson GLMM, 1k groups, MALA",
    "nested-poisson-1k-newton":
        "3-level nested Poisson GLMM, 1k groups, Newton-MH",
    "ragged-10k": "10k-group ragged hierarchical logistic",
    "ragged-10k-newton": "10k-group ragged hierarchical logistic",
    "ragged-10k-mala": "10k-group ragged hierarchical logistic, MALA",
}


def gpu_query() -> str:
    """The first card's 'name, power.limit' as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def n_params(model) -> int:
    return sum(math.prod(b.shape) for b in model.blocks)


def _unit_accept(post, at) -> dict | None:
    """The sampling acceptance across chains of the unit (group) holding
    the worst R-hat, when its block is per unit: min, median, max and the
    chains below 0.1 (a chain stuck there shows as a low min)."""
    if at is None or at["kind"] != "streamed":
        return None
    rates = gather_rates(post)[0].get(at["block"])
    if rates is None or rates.shape[1] == 1:
        return None
    a = rates[:, at["index"][0]].float().cpu()
    return {"min": float(a.min()), "median": float(a.median()),
            "max": float(a.max()), "chains_below_0.1": int((a < 0.1).sum()),
            "argmin_chain": int(a.argmin())}


def run(chains: int | None = None, warmup: int | None = None,
        draws: int | None = None, device="cuda", preset: str = "judged",
        full_rhat: bool | None = None, seed: int = 0):
    """Sample a preset (its own schedule unless overridden) from ``seed``;
    returns (result dict, Posterior, info dict of the schedule, timings
    and the peak device memory)."""
    model, data, cfg = get_preset(preset, seed=seed, device=device)
    return measure(model, data, cfg, preset, TITLES[preset], chains=chains,
                   warmup=warmup, draws=draws, full_rhat=full_rhat,
                   seed=seed)


def measure(model, data, cfg, label: str, title: str,
            chains: int | None = None, warmup: int | None = None,
            draws: int | None = None, full_rhat: bool | None = None,
            seed: int = 0):
    """:func:`run` for a given (model, data, cfg): ``label`` names it in
    the info dict, ``title`` in the metric. On a CPU device (the tests'
    small runs) the result names the CPU and the device memory, power
    limit and card are not measured (None). In a sharded run (one rank of
    a multi-process run) the per-GPU rates divide by the world size."""
    from nestmc_torch.parallel.multihost import world_size

    device = data_device(data)
    cuda = device.type == "cuda"
    over = {k: v for k, v in (("chains", chains), ("warmup", warmup),
                              ("draws", draws), ("full_rhat", full_rhat))
            if v is not None}
    cfg = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, log_every_segment=False,
                                     **over)
    )
    rc = cfg.run

    def peak_gb():
        return torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    peak_sampling = peak_gb()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_d = time.perf_counter()
    worst = post.worst_rhat()
    worst_at = post.worst_rhat_at()
    diag_s = time.perf_counter() - t_d
    wall = time.perf_counter() - t0

    sample_s = post.timings["sample_s"]
    floor = post.min_ess_argmin()
    floor_all = post.min_ess_all_params()
    gpus = world_size()
    value = post.total_ess() / sample_s / gpus
    min_rate = post.min_ess() / sample_s / gpus
    n_scalars = sum(math.prod(v.shape[2:]) for v in post.draws.values())
    info = {
        "preset": label, "seed": seed, "chains": rc.chains,
        "warmup": rc.warmup, "draws": rc.draws, "n_params": n_params(model),
        "wall_s": wall, "diagnostics_s": diag_s,
        "worst_rhat_at": worst_at,
        "worst_unit_accept": _unit_accept(post, worst_at),
        "peak_mem_gb_sampling": peak_sampling,
        "peak_mem_gb_diagnostics": peak_gb(),
        "sweeps_per_s": (rc.warmup + rc.draws)
        / (post.timings["warmup_s"] + sample_s), "gpus": gpus,
        **post.timings,
    }
    result = {
        "metric": "effective_samples_per_sec_per_gpu "
                  f"({title}; worst split R-hat over "
                  f"ALL {n_params(model)} params {worst:.4f}; "
                  f"sum-of-bulk-ESS over {n_scalars} collected scalars "
                  f"convention; min-ESS convention: {min_rate:.0f}/s/GPU)",
        "value": round(value, 1),
        "unit": "ESS/s/GPU",
        "vs_baseline": None,
        "min_ess_per_sec_per_chip": round(min_rate, 1),
        "worst_rhat_all_params": round(worst, 5),
        "min_ess_floor": (
            f"{floor['block']}{list(floor['index'])}" if floor else None
        ),
        "min_ess_all_params": (
            round(floor_all["ess"], 1) if floor_all else None
        ),
        "min_ess_all_params_lb95_per_sec_per_chip": (
            round(floor_all["ess_lb"] / sample_s / gpus, 1)
            if floor_all else None
        ),
        "min_ess_all_floor": (
            f"{floor_all['block']}{list(floor_all['index'])}"
            if floor_all else None
        ),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power_limit": gpu_query().split(",")[-1].strip() if cuda else None,
    }
    return result, post, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="judged", choices=sorted(PRESETS))
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[bench] no CUDA device: the benchmark runs on a GPU only",
              file=sys.stderr)
        return 1

    def env(name):
        v = os.environ.get(name)
        return None if v is None else int(v)

    result, post, info = run(
        chains=env("NESTMC_BENCH_CHAINS_PER_CHIP"),
        warmup=env("NESTMC_BENCH_WARMUP"), draws=env("NESTMC_BENCH_DRAWS"),
        preset=a.preset, full_rhat=True,   # the gate covers every parameter
        seed=a.seed,
    )
    print(f"[bench] {json.dumps(info)}", file=sys.stderr)
    worst = post.worst_rhat()
    if not worst < 1.01:
        print(f"[bench] worst split R-hat {worst}"
              " >= 1.01 over all parameters: benchmark rejected",
              file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
