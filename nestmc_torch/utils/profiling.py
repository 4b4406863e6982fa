"""Profiling helpers: port of :mod:`nestmc.utils.profiling`.

- ``trace(directory)``: torch.profiler over a block, its Chrome trace
  written to the directory (the command line's ``--profile DIR``), and
  ``annotate(name)``: a labelled span in that trace (the engine's
  ``nestmc.warmup.seg{i}`` and ``nestmc.sample.seg{i}``).
- ``sweep_cost``: the cost of one sweep, below.

The cost of one sweep: port of :func:`nestmc.utils.profiling.sweep_cost`.

The reference compiles one sweep and reads XLA's cost model. Eager
PyTorch has none, so the port counts one ``adapt=False`` sweep as it runs
(:func:`count_sweep`), in two parts:

- **Kernels.** Every kernel wrapper (ops/cuda/*, ``costed``) records its
  launch (kernel, C, U, n, p, noise, fold), and :func:`kernel_work` gives
  its bytes and float32 operations: each input read once and each output
  written once, and the operations of its algebra. The same function
  gives the bound that ``chip_smoke.py`` prints for every kernel, so the
  bound and the cost model cannot drift apart.
- **Plain PyTorch between the kernels**, counted by a
  ``TorchDispatchMode`` on every aten op: flops from
  ``torch.utils.flop_counter``'s registered formula where it has one (mm,
  bmm, addmm, baddbmm: 2 a multiply-add), else one a output element (a
  floor for transcendentals and for linalg ops such as a Cholesky
  factor, which have no formula there); bytes as the op's tensor inputs
  and outputs, an unfused upper bound (each op reads and writes memory
  where a fused kernel would keep its intermediates in registers). View
  and allocation ops count nothing.

The count pauses inside a kernel wrapper, so a wrapper's plain version on
the CPU counts as its kernel's :func:`kernel_work`, not as its aten ops:
the CPU and the card count the same work for the same shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

@contextlib.contextmanager
def trace(directory: str, name: str = "trace", cuda: bool | None = None):
    """torch.profiler over the block (CPU ops, and the card's kernels when
    ``cuda``, by default when a card is present); at exit its Chrome trace
    is written to ``directory/name.trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(trace_path(directory, name))


def trace_path(directory: str, name: str = "trace") -> str:
    """Where :func:`trace` writes its trace."""
    return os.path.join(directory, f"{name}.trace.json")


def annotate(name: str):
    """Label a region in the profiler timeline (a no-op's cost when no
    profiler runs)."""
    return torch.profiler.record_function(name)


# NVIDIA H100 80GB HBM3 (SXM), 700 W power limit: HBM3 memory rate and
# float32 rate outside the tensor cores, from the data sheet
HBM_BPS = 3.35e12
FP32_OPS = 67e12


def kernel_work(kernel: str, C: int, G: int, n: int, p: int,
                noise: bool = True, fold: bool = False) -> tuple:
    """(bytes, float32 operations) one call of ``kernel`` (a LAUNCHES key
    of ops/cuda) needs: each input read and each output written once; per
    obs-cell 2p (eta) + 9 (logistic value terms: exp, log1p, ...) or 5
    (Poisson: one exp) [+ 2p + 8 or 2p + 2 (gradient terms)] [+ 3T
    (Hessian; +1 for the Poisson mask)] operations, per cell the step's
    own algebra. G counts the units (groups, or subjects for pois_*).
    For the segment kernels (seg_*) ``n`` is the total number of
    observations N: they read x (N, p), y (N,) and the (G+1) row pointer,
    and evaluate C x N obs-cells. noise: the step reads external noise
    (eps, log u) instead of drawing Philox noise; fold: it folds the
    R-hat accumulators (2, G, p, C). For the noise fill (philox_fill)
    C x G is the block's rows x their elements and ``n`` the float32
    operations of an element's conversion (ops/cuda/philox_fill.FLOAT_OPS);
    it writes 4 bytes an element and reads two key words. Its Philox
    rounds (one call a quad of four elements) are integer instructions,
    which the float32 rate does not bound."""
    if kernel == "philox_fill":
        return 4 * C * G + 8, C * G * n
    if kernel.startswith("seg_"):
        val_ops = 2 * p + 9
        data = 4 * n * (p + 1) + 4 * (G + 1)
        if kernel == "seg_loglik":
            return data + 4 * C * G * (p + 1), C * n * val_ops
        return (data + 4 * C * G * (2 * p + 1),
                C * n * (val_ops + 2 * p + 8))
    pois = kernel.startswith("pois_")
    kernel = kernel[len("pois_"):] if pois else kernel
    T = p * (p + 1) // 2
    cells, obs = C * G, C * G * n
    data = 4 * G * n * (p + 2) + (4 * G if pois else 0)
    # the prior mean and log tau: mu and log tau (C, p), or per unit
    hyper = 4 * C * p + (4 * cells * p if pois else 4 * C * p)
    f = 4 * 2 * G * p * C if fold else 0          # one (2, G, p, C) array
    nz = 4 * cells * (p + 1) if noise else 0
    val_ops = 2 * p + (5 if pois else 9)
    grad_ops = val_ops + 2 * p + (2 if pois else 8)
    hess_ops = 3 * T + (1 if pois else 0)
    if kernel == "loglik":
        return data + 4 * cells * (p + 1), obs * val_ops
    if kernel == "logp_grad":
        return data + 4 * cells * (2 * p + 1), obs * grad_ops
    if kernel == "logp_grad_hess":
        return (data + 4 * cells * (2 * p + 1 + T),
                obs * (grad_ops + hess_ops))
    if kernel == "rwmh_step":
        return (data + hyper + nz + 4 * cells * (2 * p + 4),
                obs * val_ops + cells * (8 * p + 6))
    if kernel == "mala_step":
        return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4),
                obs * grad_ops + cells * (16 * p + 12 + (8 * p if fold
                                                          else 0)))
    frozen = kernel == "newton_step_frozen"
    h = 0 if frozen else 4 * cells * T
    return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4 + T) + h,
            obs * (grad_ops + (0 if frozen else hess_ops))
            + cells * (4 * p ** 3 + 30 * p + (8 * p if fold else 0)))


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for work of ``nbytes`` and ``ops`` float32 operations, the larger of
    the two over HBM_BPS and FP32_OPS."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _no_work(func) -> bool:
    """Ops that move no data: views, allocations, scalar reads."""
    name = func._overloadpacket.__name__
    return (func.is_view or name.startswith(("empty", "new_empty"))
            or name in ("detach", "lift_fresh", "_local_scalar_dense",
                        "alias", "_unsafe_view", "set_"))


class _Counter(TorchDispatchMode):
    """Counts the aten ops of plain PyTorch while active, and records the
    kernel wrappers' launches (ops/cuda.costed calls :meth:`kernel`)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = self.bytes = 0
        self.launches = []
        self.paused = 0

    @contextlib.contextmanager
    def kernel(self, record):
        if not self.paused:
            self.launches.append(record)
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or _no_work(func):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if torch.is_tensor(t)]
        outs = [t for t in tree_flatten(out)[0] if torch.is_tensor(t)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        else:
            self.flops += sum(t.numel() for t in outs)
        return out


def count_sweep(model, data, cfg, chains: int | None = None) -> dict:
    """Count one ``adapt=False`` sweep (kernels/gibbs.make_sweep) from a
    fresh init_kernel_state (seed 0) on the data's device, unsharded:
    {'launches': [(kernel, C, U, n, p, noise, fold), ...],
    'kernel_bytes', 'kernel_flops' (kernel_work summed over the
    launches), 'plain_bytes', 'plain_flops' (the aten ops between them)}.
    chains: overrides cfg.run.chains."""
    from nestmc_torch.config import ShardingConfig
    from nestmc_torch.data import data_device
    from nestmc_torch.kernels.gibbs import make_sweep
    from nestmc_torch.kernels.state import init_kernel_state
    from nestmc_torch.ops import cuda
    from nestmc_torch.rng import SweepRNG

    run = cfg.run if chains is None else dataclasses.replace(
        cfg.run, chains=chains)
    cfg = dataclasses.replace(cfg, run=run, sharding=ShardingConfig())
    rng = SweepRNG(0, data_device(data))
    state = init_kernel_state(model, cfg, rng, data)
    sweep = make_sweep(model, cfg)
    counter = _Counter()
    prev, cuda.RECORDER = cuda.RECORDER, counter
    try:
        with counter:
            sweep(state, data, False, rng)
    finally:
        cuda.RECORDER = prev
    work = [kernel_work(*rec) for rec in counter.launches]
    return {"launches": counter.launches,
            "kernel_bytes": sum(b for b, _ in work),
            "kernel_flops": sum(f for _, f in work),
            "plain_bytes": counter.bytes, "plain_flops": counter.flops}


def sweep_cost(model, data, cfg, chains: int | None = None) -> dict:
    """The reference's keys for one sweep (:func:`count_sweep`):
    flops_per_sweep, bytes_per_sweep, flops_per_sweep_per_chain,
    arithmetic_intensity (flops a byte) and sol_sweeps_per_sec_hbm (the
    sweeps a second the H100's memory rate allows at these bytes)."""
    c = count_sweep(model, data, cfg, chains)
    flops = float(c["kernel_flops"] + c["plain_flops"])
    by = float(c["kernel_bytes"] + c["plain_bytes"])
    n = chains if chains is not None else cfg.run.chains
    out = {
        "flops_per_sweep": flops,
        "bytes_per_sweep": by,
        "flops_per_sweep_per_chain": flops / max(n, 1),
        "arithmetic_intensity": flops / by if by else None,
    }
    if by:
        out["sol_sweeps_per_sec_hbm"] = HBM_BPS / by
    return out
