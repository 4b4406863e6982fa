"""Hand-written CUDA kernels for Hopper (sources in ``nestmc_torch/csrc``).

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
on CPU tensors; any other device raises. ``LAUNCHES`` counts kernel
launches per kernel: a wrapper adds one where it launches and nowhere else,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

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
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
