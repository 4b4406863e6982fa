"""Hand-written CUDA kernels for Hopper (sources in ``nestmc_torch/csrc``).

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
on CPU tensors; any other device raises. ``LAUNCHES`` counts kernel
launches per kernel: a wrapper adds one where it launches and nowhere else,
so a run can show that its main path went through the kernels.

Each wrapper is also :func:`costed`: while utils/profiling counts a sweep,
every call records its launch (kernel, C, U, n, p, noise, fold) on either
device, and the count of plain PyTorch ops stops inside it.
"""

from __future__ import annotations

import functools
import inspect

LAUNCHES = {
    "loglik": 0,
    "logp_grad": 0,
    "logp_grad_hess": 0,
    "newton_step_refresh": 0,
    "newton_step_frozen": 0,
    "mala_step": 0,
    "rwmh_step": 0,
    "pois_loglik": 0,
    "pois_logp_grad": 0,
    "pois_logp_grad_hess": 0,
    "pois_rwmh_step": 0,
    "pois_mala_step": 0,
    "pois_newton_step_refresh": 0,
    "pois_newton_step_frozen": 0,
    "seg_loglik": 0,
    "seg_logp_grad": 0,
    "philox_fill": 0,
    "asis_stats": 0,
    "asis_propose": 0,
    "asis_accept": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# the cost counter of utils/profiling while it counts a sweep, else None
RECORDER = None


def costed(describe):
    """Decorator of a kernel wrapper: while a cost count runs, the call is
    recorded as ``describe(args)`` -> (kernel, C, U, n, p, noise, fold),
    ``args`` the wrapper's arguments by name (defaults applied), and the
    count of plain ops pauses inside the call. No cost: one global read."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = RECORDER
            if rec is None:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            with rec.kernel(describe(bound.arguments)):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def obs_pass(kernel: str):
    """describe() of a padded obs pass fn(beta, x, y, mask, ...)."""
    def describe(a):
        C, U, p = a["beta"].shape
        return (kernel, C, U, a["x"].shape[1], p, False, False)
    return describe


def segment_pass(kernel: str):
    """describe() of a segment pass fn(beta, x, y, layout): n is the
    number of observations N."""
    def describe(a):
        C, _, p = a["beta"].shape
        return (kernel, C, a["layout"].num_groups, a["x"].shape[0], p,
                False, False)
    return describe


def step(kernel):
    """describe() of a step fn(beta, ..., x, ..., noise=, [rhat_fold=]);
    ``kernel`` a name or fn(args) -> name."""
    def describe(a):
        C, U, p = a["beta"].shape
        name = kernel(a) if callable(kernel) else kernel
        return (name, C, U, a["x"].shape[1], p, a["noise"] is not None,
                a.get("rhat_fold") is not None)
    return describe
