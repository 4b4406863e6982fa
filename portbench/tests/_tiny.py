"""A cell of the benchmark cut to a size the CPU tests can run, and the
faults the tests plant in the program underneath a run."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(name: str, shards=(1, 1)):
    from portbench import harness

    cell = harness.load_cell(name, ROOT / "BENCHMARK.json")
    cfg = cell.model.tiny(cell.config)
    traffic = dict(cell.traffic, chain_shards=shards[0],
                   group_shards=shards[1], calibrate_draws=4)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def plant(fault: str | None) -> None:
    """Break the program underneath a run (monkeypatching, in this
    process): 'unchanged' (every sampling sweep returns the state it was given,
    its noise drawn as before), 'half' (the sums over groups taken over the first half of
    the groups and doubled), 'altered' (one collected value of every draw
    of chain 0 moved by 1), 'exchange' (the all_reduce over group shards
    left out), 'late' (the sampling sweeps of every segment after a
    call's first return the state they were given), 'keys' (every draw of
    a sampling call takes the key words of its first), 'unadapted' (warmup
    runs the sampling sweep: Newton's metric frozen, no Robbins-Monro),
    'short' (warmup runs half of each segment's sweeps)."""
    import torch

    if fault is None:
        return
    if fault == "unchanged":
        from nestmc_torch import segments

        orig_sweep = segments.DrawProgram._sweep

        def sweep(self, state, *args, **kwargs):
            out = orig_sweep(self, state, *args, **kwargs)
            return (state, out[1]) if isinstance(out, tuple) else state
        segments.DrawProgram._sweep = sweep
    elif fault == "half":
        import nestmc_torch.models  # noqa: F401  (loads every model)

        def half(t, dim, keepdim=False):
            n = t.shape[dim] // 2
            return 2.0 * t.narrow(dim, 0, n).sum(dim, keepdim=keepdim)
        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith(
                    "nestmc_torch.models.")
                    and hasattr(mod, "groups_sum")):
                mod.groups_sum = half
    elif fault == "altered":
        from nestmc_torch import engine

        orig = engine._collect

        def collect(position, spec, derived, index):
            out = dict(orig(position, spec, derived, index))
            k = list(out)[-1]
            t = out[k].clone()
            t.view(-1)[0] += 1.0
            out[k] = t
            return out
        engine._collect = collect
    elif fault == "late":
        from nestmc_torch import segments

        orig_run = segments.DrawProgram.run
        orig_sweep = segments.DrawProgram._sweep

        def run(self, n, j0):
            self.late = j0 > self.offset
            return orig_run(self, n, j0)

        def sweep(self, state, *args, **kwargs):
            out = orig_sweep(self, state, *args, **kwargs)
            if not self.late:
                return out
            return (state, out[1]) if isinstance(out, tuple) else state
        segments.DrawProgram.run = run
        segments.DrawProgram._sweep = sweep
    elif fault == "keys":
        from nestmc_torch import segments

        orig_step = segments.DrawProgram._step

        def step(self, variant):
            if not hasattr(self, "host0"):
                self.host0 = self.rng.host.get_state()
            else:
                self.rng.host.set_state(self.host0)
            orig_step(self, variant)
        segments.DrawProgram._step = step
    elif fault == "unadapted":
        from nestmc_torch import segments
        from nestmc_torch.kernels.state import KernelState

        def compute(self, carry, rows, variant):
            state = KernelState(**carry["state"], t=self.t)
            new = self._sweep(state, self.data, False, self.rng,
                              gain=rows["gain"])
            return {"state": segments._state_tree(new)}
        segments.WarmupProgram._compute = compute
    elif fault == "short":
        from nestmc_torch import segments

        orig_warm = segments.WarmupProgram.run

        def short(self, n):
            return orig_warm(self, max(1, n // 2))
        segments.WarmupProgram.run = short
    elif fault == "exchange":
        from nestmc_torch.parallel import collectives

        collectives._all_reduce_groups = lambda t, group: t
    else:
        raise ValueError(fault)
    del torch


def run_tiny(name: str, fault: str | None = None, seed: int = 3,
             draws: int = 24, shards=(1, 1), control: bool = False):
    """The result line's object of a CPU run of the tiny cell, with
    ``fault`` planted."""
    import time

    import torch

    from portbench import harness

    torch.set_num_threads(1)
    plant(fault)
    return harness.run(tiny_cell(name, shards), seed, 1.0, False, "cpu",
                       time.monotonic(), draws=draws, control=control)


def main() -> None:
    """One rank of a sharded CPU run (gloo; NESTMC_* in the environment):
    ``python -m portbench.tests._tiny CELL FAULT OUT``; rank 0 writes the
    result to OUT."""
    from nestmc_torch.parallel import multihost

    multihost.initialize(device="cpu")
    name, fault, out = sys.argv[1], sys.argv[2], sys.argv[3]
    result = run_tiny(name, None if fault == "none" else fault,
                      shards=(2, 2))
    if result is not None:
        Path(out).write_text(json.dumps(result))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
