"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference of the cell's model
(portbench/models/<model>_reference.py, driven by the model's module).

The reference starts from carries and generator states that the run
hands it (:class:`Taken`): the carry the window started from, and two
carries that the program makes again after the window from the same
seed, each one sweep short of what it checks (the draw step's first
``k`` draws, warmup's first W - 1 sweeps). The model's module works out
from them, by the reference and as the program made them, {'first',
'late': the collected scalars of the window's first draw and of draw k,
'warm': the state after the last warmup sweep, 'carry': the caches of
the window's starting positions}. Four numbers, each with its limit from
the cell's file:

- ``step_gap``: the window's draws. From the window's starting carry and
  the generators as they stood before the window, the reference works
  out the first draw; from the carry after k draws (k inside the window's
  second segment, not its first row), with the starting carry's scales
  and frozen metric, draw k. The number is the larger of the two 90th
  percentiles over chains and collected scalars of |program -
  reference|. A percentile, and not the widest gap, because a float32
  rounding apart in an accept ratio flips the odd unit's accept decision
  (a fraction of a percent of chains); every fault of the step moves
  most entries.
- ``carry_gap``: what set-up left in the carry: the caches (loglik,
  gradient, and a frozen Hessian where there is one) of the adapted
  positions, against the reference's, as the widest gap of each over its
  largest magnitude.
- ``rhat_gap``: the streamed split R-hat of the collected scalars after
  the window, against the split R-hat the reference computes from the
  collected draws themselves (float64, two passes): the widest gap.
- ``warmup_gap``: the adapted carry. From the carry after W - 1 warmup
  sweeps, the reference works out the last warmup sweep (the metric
  refreshed, the scales' Robbins-Monro update with the gain of sweep
  W - 1) and the number is the largest, over the positions and the log
  scales, of each one's 90th percentile of |program - reference|.
  It is infinite unless the key-word generator stood where W - 1 and W
  sweeps leave it, counted from a fresh generator of the seed: so a
  warmup of fewer sweeps is caught even where its last sweep is sound.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import reference as R

NUMBERS = ("step_gap", "carry_gap", "rhat_gap", "warmup_gap")


@dataclasses.dataclass
class Taken:
    """What the reference starts from, each carry in the global layout and
    each generator state as SweepRNG.get_state gives it."""
    s0: object          # the carry the window started from
    snapshot: dict      # the generators before the window
    k: int              # the window's late draw
    sk: object          # the carry after the window's first k draws
    snap_k: dict        # the generators after them
    sw: object          # the carry after warmup's first W - 1 sweeps
    snap_w: dict        # the generators after them
    host0: torch.Tensor  # the key-word generator of a fresh SweepRNG


def mode(device) -> str:
    """The program's noise mode on ``device``: 'kernel' (the fused step
    draws its Philox noise inside the kernel) on the card, 'fill' (two
    counter-indexed fills) on the CPU."""
    return "kernel" if torch.device(device).type == "cuda" else "fill"


def p90(x: torch.Tensor) -> float:
    """The 90th percentile (linear between order statistics, as
    torch.quantile) of ``x``'s entries, NaN counted as infinite."""
    v = torch.sort(torch.nan_to_num(x.reshape(-1).double(),
                                    nan=float("inf"))).values
    pos = 0.9 * (v.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, v.numel() - 1)
    a, b = float(v[lo]), float(v[hi])
    return a if a == b else a + (pos - lo) * (b - a)


def step_gap(prog: dict, ref: dict) -> tuple:
    """(90th percentile, widest) |program - reference| over every chain's
    collected scalars of one draw."""
    gaps = torch.cat([(prog[k].float() - ref[k].float()).abs().reshape(-1)
                      for k in ref])
    gaps = torch.nan_to_num(gaps, nan=float("inf"))
    return p90(gaps), float(gaps.max())


def carry_gap(cache: dict, ref: dict) -> float:
    worst = 0.0
    for k, r in ref.items():
        d = (cache[k].float() - r).abs().max()
        worst = max(worst, float(torch.nan_to_num(d, nan=float("inf"))
                                 / r.abs().max().clamp_min(1e-30)))
    return worst


def warm_gap(prog: dict, ref: dict) -> dict:
    """{leaf: 90th percentile of |program - reference|} of the state
    after the last warmup sweep."""
    return {k: p90((prog[k].float() - r.float()).abs())
            for k, r in ref.items() if prog.get(k) is not None}


def keys_counted(taken: Taken, warmup: int, keys: int) -> bool:
    """Whether the key-word generator stood where W - 1 sweeps (the
    rerun) and W sweeps (the window's start) leave a fresh one, each sweep
    taking ``keys`` pairs of words (the model's KEYS of the mode)."""
    w1 = R.advance_keys(taken.host0, warmup - 1, keys)
    w = R.advance_keys(w1, 1, keys)
    return (torch.equal(w1, taken.snap_w["host"].cpu())
            and torch.equal(w, taken.snapshot["host"].cpu()))


def gaps(prog: dict, ref: dict) -> tuple:
    """(step_gap, carry_gap and warmup_gap of ``prog`` against ``ref``,
    what else was read)."""
    first, first_w = step_gap(prog["first"], ref["first"])
    late, late_w = step_gap(prog["late"], ref["late"])
    warm = warm_gap(prog["warm"], ref["warm"])
    numbers = {"step_gap": max(first, late),
               "carry_gap": carry_gap(prog["carry"], ref["carry"]),
               "warmup_gap": max(warm.values())}
    return numbers, {"first_p90": first, "late_p90": late,
                     "first_widest": first_w, "late_widest": late_w,
                     "warm_p90": warm}


def rhat_gap(full_rhat: dict, draws: dict, rthin: int,
             tf32: bool = False) -> float:
    """Widest |streamed R-hat - reference split R-hat| over the collected
    scalars; ``tf32``: the control, the reference's accumulators held in
    TF32, in the program's place (``full_rhat`` then unused)."""
    worst = 0.0
    for k, d in draws.items():
        ref = R.split_rhat(d, rthin)
        if tf32:
            got = R.split_rhat_tf32(d, rthin)
        else:
            got = full_rhat[k][:d.shape[2]] if d.ndim > 3 else full_rhat[k]
        gap = (got.double().reshape(ref.shape) - ref).abs().max()
        worst = max(worst, float(torch.nan_to_num(gap, nan=float("inf"))))
    return worst


def decide(numbers: dict, limits: dict) -> bool:
    """Correct when every number lies under its limit."""
    return all(numbers[k] < limits[k] for k in NUMBERS)
