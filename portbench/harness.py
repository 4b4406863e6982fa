"""One run of one cell in one process (on four chips: one rank of it).

The order of a run:

1. Inputs: the configuration's data (its model's frozen generator,
   portbench/models/<model>_reference.py, from the file's ``data_seed``:
   one data set a configuration, so that a seed changes the chains and
   not the posterior they sample), handed to the program through its
   public constructors with the values of the configuration's file (the
   model's module, portbench/models/<model>.py); ``--seed`` seeds the
   chains.
2. Set-up: a short warmup of ``PREWARM_SWEEPS`` sweeps on a generator of
   its own (the process's first call of the warmup step), then the
   configuration's warmup through
   ``nestmc_torch.engine.warmup_then_state`` (timed: warmup_sweeps_per_s),
   then a short calibration call of the draw step on a copy of the
   generators, from which the window's draw count D is sized so that the
   window lasts about ``--seconds`` (the streamed split R-hat needs D
   before the call).
3. Window: one ``nestmc_torch.engine.sample`` call of D draws from the
   adapted carry (``skip_warmup``), timed by the harness's own clock and
   ended by a synchronise: the capture of the draw step, every replay, the
   finalize of the streamed R-hat and, sharded, the final gathers.
4. After it: the peak device memory is read; with ``--trace 1`` a bounded
   stretch of further draws runs under the profiler (portbench/trace.py);
   the program makes again, from the same seed, the carries the check
   starts from (the window's first k draws from its starting carry and
   generators, and warmup's first W - 1 sweeps); then the ESS of the
   collected draws (portbench/ess.py) and the comparison with the plain
   reference (portbench/check.py).

Whatever knows the model (its data, its constructors, the kernels it
builds, the shapes of its carry, its reference, its work counts) is asked
of the model's module (``Cell.model``); this file names no model.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

from portbench import models

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nestmc")
GATE = 1.01
# warmup sweeps run before the timed warmup (see run)
PREWARM_SWEEPS = 32


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names, compared whole, of the loaded modules that the
    benchmark's processes may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json with the files it names: its configuration,
    its traffic (the sharding layout and the lengths of the calibration
    and the traced stretch) and its own file (the limits of the check),
    the metrics it reports, and the module of the configuration's model
    (portbench/models/<model>.py)."""
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list
    model: types.ModuleType


def load_cell(name: str, bench: str | Path = "BENCHMARK.json",
              here: Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark file ``bench`` (its directory is
    the checkout's root)."""
    spec = _json(bench)
    root = Path(bench).resolve().parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {bench}: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    config = _json(root / cfg["file"])
    return Cell(name=name, config=config,
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]),
                limits=_json(here / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per,
                model=models.load(config["model"]))


def reader(name: str, here: Path = HERE):
    """The ``read(ctx)`` function of metric ``name``
    (portbench/metrics/<name>.py)."""
    path = here / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a metric reads: the cell, the host-clock results of the run
    (``run``), the traced stretch's summary (``trace``, None without one)
    and this process's shapes (the model's ``shapes``)."""
    cell: Cell
    run: dict
    trace: object
    shapes: dict


def gpu_query() -> str:
    """'name, power.limit' of the first card, as nvidia-smi prints them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dist():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _all(values: list, device) -> list:
    """``values`` (floats) of every rank, rank by rank (one rank: its
    own)."""
    import torch

    dist = _dist()
    if dist is None:
        return [list(values)]
    t = torch.tensor(values, dtype=torch.float64, device=device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def program(cell: Cell, seed: int, device):
    """(model, data, SamplerConfig, data arrays) of the cell, built
    through the program's public constructors by the model's module."""
    arrays = cell.model.data(cell.config)
    model, data, cfg = cell.model.build(cell.config, cell.traffic, arrays,
                                        seed, device)
    return model, data, cfg, arrays


def _with(cfg, **run):
    return dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, **run))


def _gather_carry(model, data, cfg, part):
    """The global layout of a rank's part of a carry (a collective)."""
    from nestmc_torch.parallel.sharding import (
        Placement,
        gather_state,
        make_mesh,
        make_shard,
        state_shardings,
    )

    mesh = make_mesh(cfg)
    if mesh is None:
        return part
    post = types.SimpleNamespace(
        placement=Placement(make_shard(model, data, cfg, mesh),
                            state_shardings(model, cfg, mesh)),
        final_state=part)
    return gather_state(post)


def _connect(cfg, device) -> None:
    """Make the NCCL communicators of the default group and of the mesh's
    groups (each is made at its first collective) in set-up, before the
    warmup's clock starts."""
    import torch

    from nestmc_torch.parallel import make_mesh

    dist = _dist()
    zero = torch.zeros(1, device=device)
    dist.all_reduce(zero)
    mesh = make_mesh(cfg)
    for g in (() if mesh is None else (mesh.chains_group,
                                       mesh.groups_group)):
        if g is not None:
            dist.all_reduce(zero, group=g)
    _sync(device)


def late_draw(cfg: dict, draws: int) -> int:
    """The window's draw that the check works out besides its first: the
    second of the window's second segment (a later segment's replay, and
    not the first row of its tables)."""
    return min(int(cfg["segment_size"]) + 1, draws - 1)


def _take(model, data, cfg, c: dict, s0, snapshot, k: int, seed: int,
          device):
    """(check.Taken, what the reruns took): the carries the check starts
    from, made again by the program after the window from the same seed:
    the window's first ``k`` draws from its starting carry and generators,
    and warmup's first W - 1 sweeps from a fresh generator of the seed."""
    from nestmc_torch import SweepRNG
    from nestmc_torch.engine import sample

    from portbench import check

    t = time.monotonic()
    rk = SweepRNG(seed, device)
    rk.set_state(snapshot)
    post = sample(model, data, _with(cfg, draws=k), rng=rk, init_state=s0,
                  skip_warmup=True)
    sk, snap_k = post.final_state, rk.get_state()
    del post
    _sync(device)
    late_s = time.monotonic() - t
    t = time.monotonic()
    rw = SweepRNG(seed, device)
    host0 = rw.get_state()["host"]
    post = sample(model, data, _with(cfg, warmup=int(c["warmup"]) - 1,
                                     draws=0), rng=rw)
    sw, snap_w = post.final_state, rw.get_state()
    took = {"late_k": k, "late_s": late_s, "warmup_s": post.timings[
        "warmup_s"], "warmup_capture_s": post.timings["capture_s"]}
    del post
    _sync(device)
    took["warmup_wall_s"] = time.monotonic() - t
    return check.Taken(
        s0=_gather_carry(model, data, cfg, s0), snapshot=snapshot, k=k,
        sk=_gather_carry(model, data, cfg, sk), snap_k=snap_k,
        sw=_gather_carry(model, data, cfg, sw), snap_w=snap_w,
        host0=host0), took


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, draws: int | None = None,
        control: bool = False) -> dict | None:
    """One run of ``cell``; returns the result line's object on the
    process that prints it (rank 0), None on the others. ``draws`` fixes
    the window's draw count (tests); ``control``: the control (the
    reference in TF32) in the program's place, so that the line's check
    and ``correct`` are the control's (the program's numbers go to
    standard error)."""
    import torch

    from nestmc_torch import SweepRNG
    from nestmc_torch.engine import sample, warmup_then_state

    from portbench import check
    from portbench import ess as E
    from portbench import trace as T

    c, tr = cell.config, cell.traffic
    phases = {"start": t_start}
    dist = _dist()
    rank = dist.get_rank() if dist else 0
    world = dist.get_world_size() if dist else 1
    if tr["chain_shards"] * tr["group_shards"] != world:
        raise RuntimeError(f"{cell.name} runs on {tr['chain_shards']} x "
                           f"{tr['group_shards']} ranks, not {world}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    phases["imported"] = time.monotonic()
    model, data, cfg, arrays = program(cell, seed, device)
    phases["data"] = time.monotonic()

    # ---- set-up: the kernels (built on a checkout's first run), warmup,
    # then the calibration of the draw step ----
    if cuda:
        cell.model.prepare(c)
    phases["kernels"] = time.monotonic()
    if dist:
        _connect(cfg, device)
    phases["connected"] = time.monotonic()
    # the warmup step once, short and on a generator of its own, so that
    # a process's first-call costs (module loads, first allocations) fall
    # in set-up and not inside warmup_sweeps_per_s's clock
    warmup_then_state(model, data, _with(cfg, warmup=min(
        PREWARM_SWEEPS, int(c["warmup"]))), SweepRNG(seed, device))
    _sync(device)
    phases["prewarmed"] = time.monotonic()
    rng = SweepRNG(seed, device)
    _sync(device)
    t_w = time.monotonic()
    s0 = warmup_then_state(model, data, cfg, rng)
    _sync(device)
    warmup_s = time.monotonic() - t_w
    phases["warmup"] = time.monotonic()
    k = int(tr["calibrate_draws"])
    cal = SweepRNG(seed, device)
    cal.set_state(rng.get_state())
    t_c = time.monotonic()
    post_c = sample(model, data, _with(cfg, draws=k), rng=cal,
                    init_state=s0, skip_warmup=True)
    _sync(device)
    wall_c = time.monotonic() - t_c
    per_draw = post_c.timings["sample_s"] / k
    fixed = wall_c - post_c.timings["sample_s"]
    del post_c, cal
    if draws is None:
        draws = max(64, int((seconds - fixed) / per_draw))
        draws -= draws % 2
    if dist:
        d = torch.tensor([draws], dtype=torch.long, device=device)
        dist.broadcast(d, 0)
        draws = int(d.item())

    # ---- the window ----
    snapshot = rng.get_state()
    _sync(device)
    t0 = time.monotonic()
    phases["calibrated"] = t0
    post = sample(model, data, _with(cfg, draws=draws), rng=rng,
                  init_state=s0, skip_warmup=True)
    _sync(device)
    t1 = time.monotonic()
    window_s = t1 - t0
    peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    peak = int(max(v[0] for v in _all([float(peak)], device)))
    log(f"rank {rank}: draws {draws} in {window_s:.4f} s (calibrated "
        f"{per_draw * 1e3:.4f} ms a draw, {fixed:.4f} s outside the "
        f"replays); warmup {warmup_s:.4f} s; capture "
        f"{post.timings['capture_s']:.4f} s); set-up phases "
        + json.dumps({k: round(v - t_start, 4) for k, v in phases.items()}))

    shapes = cell.model.shapes(c, s0)
    summary, busy = None, None
    if trace:
        S = int(tr["trace_draws"])
        tcfg = _with(cfg, draws=2 * S, segment_size=S)
        events = T.profile(lambda: sample(model, data, tcfg, rng=rng,
                                          init_state=post.final_state,
                                          skip_warmup=True))
        summary = T.summarize(
            events, c["thin"],
            work=lambda name, i: cell.model.launch_work(name, i, c, shapes),
            extra=cell.model.HAND_WRITTEN)
        del events
        mine = ([summary.busy_s, summary.stretch_s] if summary
                else [0.0, 0.0])
        every = _all(mine, device)
        busy = [sum(v[i] for v in every) / len(every) for i in (0, 1)]

    # the program's state is let go before the reference runs
    capture_s = post.timings["capture_s"]
    draws_out, full_rhat = post.draws, post.full_rhat
    del post
    taken, took = _take(model, data, cfg, c, s0, snapshot,
                        late_draw(c, draws), seed, device)
    del s0
    if cuda:
        torch.cuda.empty_cache()
    log(f"rank {rank}: reruns for the check " + json.dumps(took))
    if rank != 0:
        del taken
        if dist:
            dist.barrier()
        return None

    attempted = sum(int(v.numel()) for v in full_rhat.values())
    failed = sum(int((~(v < GATE)).sum()) for v in full_rhat.values())
    ess = torch.cat([E.ess_bulk(v) for v in draws_out.values()])
    numbers, extra = _check(cell, taken, draws_out, full_rhat, arrays,
                            device, control)
    if dist:
        dist.barrier()
    ctx = Context(cell=cell, shapes=shapes, trace=summary, run={
        "window_s": window_s, "setup_s": t0 - t_start,
        "warmup_s": warmup_s, "warmup_sweeps": c["warmup"],
        "draws": draws, "sweeps": draws * c["thin"], "gpus": world,
        "ess_sum": float(ess.sum()), "ess_min": float(ess.min()),
        "capture_s": capture_s,
        "busy_s": busy[0] if busy else None,
        "stretch_s": busy[1] if busy else None})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    card = gpu_query() if cuda else ""
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": world, "memory_peak_bytes": peak,
           "power_limit": card.split(",")[-1].strip() if card else None}
    if trace:
        dev["busy_s"], dev["window_s"] = busy
    result = {"correct": check.decide(numbers, cell.limits),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    log(f"draws {draws}, ESS sum {float(ess.sum()):.1f} min "
        f"{float(ess.min()):.2f}, gate failures {failed} of {attempted}, "
        f"{json.dumps(extra)}")
    result["check"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                       for k in check.NUMBERS}
    return result


def _check(cell, taken, draws, full_rhat, arrays, device, control):
    """The check's numbers {name: value} (with ``control``, the
    control's) and what else it read."""
    import torch

    from portbench import check

    c, M = cell.config, cell.model
    rthin, warmup = c["full_rhat_thin"], int(c["warmup"])
    t = time.monotonic()
    ref = M.outputs(M.reference(c, arrays, device), taken, c, device)
    numbers, read = check.gaps(M.program_outputs(taken, draws), ref)
    numbers["rhat_gap"] = check.rhat_gap(full_rhat, draws, rthin)
    read["keys_counted"] = check.keys_counted(
        taken, warmup, M.KEYS[check.mode(device)])
    if not read["keys_counted"]:
        numbers["warmup_gap"] = float("inf")
    extra = {"program": numbers, "read": read}
    if control:
        low = M.reference(c, arrays, device, tf32=True)
        numbers, read = check.gaps(M.outputs(low, taken, c, device), ref)
        numbers["rhat_gap"] = check.rhat_gap(full_rhat, draws, rthin,
                                             tf32=True)
        extra["control"], extra["control_read"] = numbers, read
    del ref
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    extra["check_s"] = time.monotonic() - t
    return numbers, extra
