"""Command line: ``python -m nestmc_torch run --preset hier-logistic-100``.

Port of :mod:`nestmc.cli`, on the card unless ``--device cpu`` asks for
the kernels' plain versions on the CPU (without a card, ``run`` fails).

Subcommands:
  run           run a named preset (with overrides) and print summaries
  compare       rank saved runs by WAIC / PSIS-LOO (compare.py)
  list-presets  show the presets

Flags of note: --checkpoint-dir/--checkpoint-every/--resume (restart
recovery: the carry, the RNG and the streamed R-hat accumulators), --scale
(shrink a preset), --collect and --save-draws (an npz of the draws in the
reference's layout, with ``__meta__`` a JSON string, and the streamed
all-parameter R-hat as ``__full_rhat__.<block>``), --metric-json (the
benchmark metric line), --profile DIR (a torch.profiler trace with the
draw step's device-timed spans as a track of their own; ``timings`` then
holds each span's ms a sweep, which --metric-json prints),
--debug-nans (fail at the first segment whose position holds a NaN).
--cost-analysis (one sweep's flops, bytes and speed-of-light sweeps/s on
stderr before the run: utils/profiling.sweep_cost, the kernels' work and
the plain ops between them counted as the sweep runs).
``--enable-checks`` sets a JAX-internal flag and exits 2.
--chain-shards/--group-shards run one rank of a multi-process launch
(NESTMC_COORDINATOR_ADDRESS / NESTMC_NUM_PROCESSES / NESTMC_PROCESS_ID or
torchrun's env; parallel/multihost.py): their product must be the number
of processes (else exit 2), each rank runs on its own card (or its share
of one, or the CPU with ``--device cpu``), and only the primary rank
prints, saves draws and writes checkpoints.

A resume differs from the reference's in one way: a sample-phase
checkpoint without the streamed accumulators, resumed into a full_rhat
run, exits 2 instead of certifying the gate over the remaining draws only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from nestmc_torch.utils.logging import get_logger


def _build_parser():
    p = argparse.ArgumentParser(
        prog="nestmc_torch",
        description="MCMC for nested data on one NVIDIA GPU (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a preset")
    r.add_argument("--preset", required=True)
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    r.add_argument("--scale", type=float, default=1.0,
                   help="shrink factor for draws/warmup (and synth sizes)")
    r.add_argument("--chains", type=int)
    r.add_argument("--warmup", type=int)
    r.add_argument("--draws", type=int)
    r.add_argument("--thin", type=int)
    r.add_argument("--seed", type=int)
    r.add_argument("--segment-size", type=int)
    r.add_argument("--algorithm", choices=["rwmh", "mala", "newton"])
    r.add_argument("--precond", choices=["none", "diag", "full"])
    r.add_argument("--chain-shards", type=int)
    r.add_argument("--group-shards", type=int)
    r.add_argument("--checkpoint-dir")
    r.add_argument("--checkpoint-every", type=int)
    r.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    r.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace to DIR, with the draw "
                        "step's device-timed spans (timings['spans'])")
    r.add_argument("--log-rhat", action="store_true",
                   help="log the worst split R-hat of the draws so far "
                        "each segment")
    r.add_argument("--cost-analysis", action="store_true",
                   help="print one sweep's counted flops and bytes and "
                        "its speed-of-light sweeps/s (stderr)")
    r.add_argument("--debug-nans", action="store_true",
                   help="fail at the first segment whose position holds a "
                        "NaN")
    r.add_argument("--enable-checks", action="store_true",
                   help="JAX's internal checks: not in this package "
                        "(exit 2)")
    r.add_argument("--metric-json", action="store_true",
                   help="print the benchmark metric as one JSON line")
    r.add_argument("--quiet", action="store_true")
    r.add_argument(
        "--collect", metavar="SPEC",
        help="override collected quantities: comma-separated names, each "
             "optionally ':k' for the first k units (e.g. "
             "'mu,log_tau,beta:8,group_loglik'); names may be blocks or "
             "model derived quantities",
    )
    r.add_argument(
        "--save-draws", metavar="PATH.npz",
        help="save collected draw arrays (chains x draws x ...) to an "
             ".npz for offline analysis / `compare`",
    )

    c = sub.add_parser(
        "compare",
        help="rank saved runs by WAIC or PSIS-LOO "
             "(runs saved with `run --collect ...,group_loglik "
             "--save-draws PATH`)",
    )
    c.add_argument("paths", nargs="+", metavar="PATH.npz")
    c.add_argument("--unit", default="group_loglik",
                   help="per-unit loglik array name in the .npz "
                        "(default: group_loglik)")
    c.add_argument("--method", choices=["loo", "waic"], default="loo")

    sub.add_parser("list-presets", help="list available presets")
    return p


def _apply_overrides(cfg, args):
    run_over = {
        k: getattr(args, k)
        for k in ("chains", "warmup", "draws", "thin", "seed",
                  "checkpoint_dir", "checkpoint_every")
        if getattr(args, k, None) is not None
    }
    if args.segment_size is not None:
        run_over["segment_size"] = args.segment_size
    if args.quiet:
        run_over["log_every_segment"] = False
    if getattr(args, "collect", None):
        spec = {}
        for item in args.collect.split(","):
            name, _, k = item.strip().partition(":")
            spec[name] = int(k) if k else None
        run_over["collect"] = spec
    if getattr(args, "log_rhat", False):
        run_over["log_rhat"] = True
    kern_over = {
        k: getattr(args, k)
        for k in ("algorithm", "precond")
        if getattr(args, k, None) is not None
    }
    shard_over = {
        k: getattr(args, k)
        for k in ("chain_shards", "group_shards")
        if getattr(args, k, None) is not None
    }
    return dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, **run_over),
        kernel=dataclasses.replace(cfg.kernel, **kern_over),
        sharding=dataclasses.replace(cfg.sharding, **shard_over),
    )


# the settings a checkpoint's carry and streamed gate depend on
_CARRY_RUN = ("chains", "warmup", "draws", "thin", "seed", "full_rhat",
              "full_rhat_thin")


def _carry_settings(cfg: dict) -> dict:
    return {"kernel": cfg["kernel"],
            "run": {k: cfg["run"][k] for k in _CARRY_RUN}}


class _Refused(Exception):
    """A resume the command refuses (exit 2, the message on stderr)."""


def _load_resume(model, data, cfg) -> dict:
    """sample()'s resume arguments from the latest checkpoint: rng,
    init_state, init_acc, skip_warmup, draws_offset; raises _Refused."""
    from nestmc_torch.checkpoint import latest_tag, load_checkpoint
    from nestmc_torch.data import data_device
    from nestmc_torch.kernels.state import checkpoint_template
    from nestmc_torch.rng import SweepRNG

    ckdir = cfg.run.checkpoint_dir
    tag = latest_tag(ckdir) if ckdir else None
    if tag is None:
        raise _Refused(f"no checkpoint found in {ckdir!r}")
    with open(os.path.join(ckdir, f"meta_{tag}.json")) as f:
        meta = json.load(f)
    phase, has_acc = meta.get("phase"), meta.get("has_acc", False)
    done = int(meta.get("draws_done", 0)) if phase == "sample" else 0
    if done and cfg.run.full_rhat and not has_acc:
        raise _Refused(
            f"checkpoint {tag} holds {done} sampled draws but no streamed "
            "R-hat accumulators: resuming it would certify the "
            "all-parameter gate over the remaining draws only; rerun from "
            "the start or from a checkpoint that has them")
    if _carry_settings(meta["config"]) != _carry_settings(cfg.to_dict()):
        raise _Refused(
            f"checkpoint {tag} was written with other settings: "
            f"{_carry_settings(meta['config'])} != "
            f"{_carry_settings(cfg.to_dict())}")
    template = checkpoint_template(model, cfg, data, with_acc=has_acc)
    carry, meta = load_checkpoint(ckdir, tag, template)
    rng = SweepRNG(cfg.run.seed, data_device(data))
    rng.set_state(carry["rng"])
    print(f"resuming from {tag} (phase={phase})", file=sys.stderr)
    if done:
        print(f"resume: checkpoint holds {done} sampled draws; running the "
              f"remaining {max(cfg.run.draws - done, 0)} of "
              f"{cfg.run.draws} (earlier draws are not retained)",
              file=sys.stderr)
    return {"rng": rng, "init_state": carry["state"],
            "init_acc": carry.get("acc") if cfg.run.full_rhat else None,
            "skip_warmup": phase == "sample", "draws_offset": done}


def cmd_run(args) -> int:
    if args.enable_checks:
        print("--enable-checks (JAX's internal checks) is not available in "
              "nestmc_torch: it belongs to the JAX package (python -m "
              "nestmc)", file=sys.stderr)
        return 2

    from nestmc_torch.config import validate
    from nestmc_torch.data import check_device
    from nestmc_torch.engine import sample
    from nestmc_torch.parallel import make_mesh, multihost
    from nestmc_torch.presets import get_preset

    try:
        device = check_device(args.device)
        # a multi-process launch (NESTMC_* or torchrun env): one rank each
        multihost.initialize(device=device.type)
        if multihost.world_size() > 1:
            device = multihost.device()
        model, data, cfg = get_preset(
            args.preset, seed=args.seed or 0, device=device,
            scale=args.scale)
        cfg = _apply_overrides(cfg, args)
        validate(cfg)
        make_mesh(cfg)
    except (RuntimeError, KeyError, ValueError, NotImplementedError) as e:
        print(f"run: {e}", file=sys.stderr)
        return 2
    primary = multihost.is_primary()

    if args.cost_analysis and primary:
        from nestmc_torch.utils.profiling import sweep_cost

        costs = sweep_cost(model, data, cfg)
        print("sweep cost analysis:", json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in costs.items()}), file=sys.stderr)

    get_logger(level=logging.WARNING if args.quiet else logging.INFO)
    kw = {}
    if args.resume:
        t_r = time.perf_counter()
        try:
            kw = _load_resume(model, data, cfg)
        except _Refused as e:
            print(e, file=sys.stderr)
            return 2
        resume_s = time.perf_counter() - t_r

    prof = contextlib.nullcontext()
    if args.profile and primary:
        from nestmc_torch.utils.profiling import trace

        prof = trace(args.profile, args.preset, device.type == "cuda")
    t0 = time.perf_counter()
    try:
        with prof:
            post = sample(model, data, cfg, debug_nans=args.debug_nans,
                          spans=bool(args.profile), **kw)
    except FloatingPointError as e:
        print(f"run: {e}", file=sys.stderr)
        return 1
    wall = time.perf_counter() - t0
    if args.resume:
        post.timings["resume_s"] = resume_s
    if not primary:
        return 0
    if args.profile:
        from nestmc_torch.utils.profiling import add_track, trace_path

        path = trace_path(args.profile, args.preset)
        if post.spans is not None:
            add_track(path, post.spans.events())
        print(f"profile trace written to {path}", file=sys.stderr)

    if args.save_draws:
        full = {f"__full_rhat__.{k}": v.cpu().numpy()
                for k, v in (post.full_rhat or {}).items()}
        np.savez(
            args.save_draws,
            __meta__=json.dumps({
                "preset": args.preset,
                "config": post.config,
                "worst_rhat": float(post.worst_rhat()),
                "draws_offset": kw.get("draws_offset", 0),
            }, default=str),
            **{k: v.cpu().numpy() for k, v in post.draws.items()},
            **full,
        )
        print(f"draws saved to {args.save_draws}", file=sys.stderr)

    if not args.metric_json:
        print(post.summary_table())
        print(f"\nworst R-hat: {post.worst_rhat():.4f}")
        print(f"wall: {wall:.1f}s  timings: "
              + json.dumps({k: round(v, 2) if isinstance(v, float) else v
                            for k, v in post.timings.items()}))
    else:
        sample_s = max(post.timings.get("sample_s", wall), 1e-9)
        total_ess = post.total_ess()
        gpus = multihost.world_size()
        print(json.dumps({
            "preset": args.preset,
            "metric": "effective_samples_per_sec_per_gpu",
            "value": total_ess / sample_s / gpus,
            "unit": "ESS/s/GPU",
            "total_ess": total_ess,
            "min_ess": post.min_ess(),
            # measured over all params (streamed cross-chain estimator);
            # None unless the run streamed full_rhat
            "min_ess_all_params": post.min_ess_all_params(),
            "worst_rhat": post.worst_rhat(),
            "rhat_params_streamed": (
                sum(v.numel() for v in post.full_rhat.values())
                if post.full_rhat else None),
            "sample_s": sample_s,
            "timings": post.timings,
            "backend": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
            "n_devices": gpus,
            "config": post.config,
        }, default=str))
    return 0


def cmd_compare(args) -> int:
    from nestmc_torch.compare import compare, psis_loo, waic

    method = psis_loo if args.method == "loo" else waic
    results = {}
    for path in args.paths:
        with np.load(path, allow_pickle=False) as z:
            if args.unit not in z:
                avail = sorted(k for k in z.files if not k.startswith("__"))
                print(
                    f"{path}: no array {args.unit!r}; available: {avail} "
                    f"(re-run with --collect ...,{args.unit} "
                    f"--save-draws)", file=sys.stderr,
                )
                return 2
            results[path] = method(z[args.unit])
    rows = compare(results)
    for row in rows:
        extra = ""
        if args.method == "loo":
            kh = results[row["model"]]["k_hat"]
            extra = f"  k_hat>0.7: {int((kh > 0.7).sum())}/{kh.size}"
        print(
            f"{row['model']:<40} elpd={row['elpd']:>12.2f}  "
            f"diff={row['elpd_diff']:>9.2f} +- {row['diff_se']:.2f}{extra}"
        )
    print(json.dumps(rows, default=str))
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "list-presets":
        from nestmc_torch.presets import PRESETS
        for name, fn in PRESETS.items():
            print(f"{name:<26} {fn.__doc__.strip().splitlines()[0]}")
        return 0
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "compare":
        return cmd_compare(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
