"""The judged benchmark on one GPU: ``python -m nestmc_torch.bench``.

Port of the repo's bench.py: the 1k-group hierarchical logistic model
(G=1000 groups x n=50 obs, p=4), 1024 chains, 1500 warmup sweeps and 4096
retained draws, frozen-metric Newton-MH with the fused step, the
inverse-gamma tau prior, streamed split R-hat over all 4008 parameters.
Prints one JSON line with bench.py's fields; ``value`` is the sum of bulk
ESS over the 40 collected scalars (mu 4 + log_tau 4 + the first 8 groups'
beta 32) per sampling second per GPU. Warmup is excluded from the
denominator. The run is rejected (exit 1) unless the worst R-hat over all
parameters is below 1.01. ``vs_baseline`` is null: the repo's 125k
ESS/s/chip north star was set for TPU chips. It needs a CUDA device.

Environment overrides: NESTMC_BENCH_CHAINS_PER_CHIP, NESTMC_BENCH_WARMUP,
NESTMC_BENCH_DRAWS.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.engine import sample
from nestmc_torch.models import make_hier_logistic, synth_logistic

JUDGED = {"G": 1000, "n": 50, "p": 4, "data_seed": 2000}
N_PARAMS = 4 + 4 + 1000 * 4


def gpu_query() -> str:
    """The first card's 'name, power.limit' as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def judged_config(chains: int, warmup: int, draws: int) -> SamplerConfig:
    return SamplerConfig(
        kernel=KernelConfig(algorithm="newton", fused_accept=True),
        run=RunConfig(
            chains=chains, warmup=warmup, draws=draws, seed=0,
            segment_size=2048,
            collect={"mu": None, "log_tau": None, "beta": 8},
            full_rhat=True, log_every_segment=False,
        ),
    )


def run(chains: int = 1024, warmup: int = 1500, draws: int = 4096,
        device="cuda"):
    """Sample the judged config; returns (result dict, Posterior, info
    dict of the schedule and timings)."""
    data, _ = synth_logistic(
        JUDGED["data_seed"], G=JUDGED["G"], n=JUDGED["n"], p=JUDGED["p"],
        device=device,
    )
    model = make_hier_logistic(data, tau_prior="invgamma", asis_repeats=1)
    cfg = judged_config(chains, warmup, draws)
    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    wall = time.perf_counter() - t0

    sample_s = post.timings["sample_s"]
    worst = post.worst_rhat()
    floor = post.min_ess_argmin()
    floor_all = post.min_ess_all_params()
    value = post.total_ess() / sample_s
    min_rate = post.min_ess() / sample_s
    info = {
        "chains": chains, "warmup": warmup, "draws": draws, "wall_s": wall,
        "sweeps_per_s": (warmup + draws)
        / (post.timings["warmup_s"] + sample_s),
        **post.timings,
    }
    result = {
        "metric": "effective_samples_per_sec_per_gpu "
                  "(1k-group hierarchical logistic; worst split R-hat over "
                  f"ALL {N_PARAMS} params {worst:.4f}; "
                  "sum-of-bulk-ESS over 40 collected scalars convention; "
                  f"min-ESS convention: {min_rate:.0f}/s/GPU)",
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
            round(floor_all["ess_lb"] / sample_s, 1) if floor_all else None
        ),
        "min_ess_all_floor": (
            f"{floor_all['block']}{list(floor_all['index'])}"
            if floor_all else None
        ),
        "device": torch.cuda.get_device_name(torch.device(device)),
        "power_limit": gpu_query().split(",")[-1].strip(),
    }
    return result, post, info


def main() -> int:
    if not torch.cuda.is_available():
        print("[bench] no CUDA device: the benchmark runs on a GPU only",
              file=sys.stderr)
        return 1
    result, post, info = run(
        chains=int(os.environ.get("NESTMC_BENCH_CHAINS_PER_CHIP", 1024)),
        warmup=int(os.environ.get("NESTMC_BENCH_WARMUP", 1500)),
        draws=int(os.environ.get("NESTMC_BENCH_DRAWS", 4096)),
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
