"""The yardstick of the kernels: a frozen copy of the program's per-call work
counts (bytes and float32 operations, each input read once and each output
written once), the card's published peaks, and the names by which the
profiler shows the program's hand-written kernels."""

from __future__ import annotations

import re

# NVIDIA H100 80GB HBM3 (SXM) at 700 W, NVIDIA's data sheet: HBM3 bandwidth
# and the float32 rate outside the tensor cores
HBM_BPS = 3.35e12
FP32_OPS = 67e12

# the __global__ templates of the program's CUDA sources and their template
# parameters after (family, P); NCCL's kernels are named ncclKernel* or
# ncclDevKernel*
HAND_WRITTEN = {
    "newton_step_kernel": ("FROZEN", "FOLD", "EXT"),
    "mala_step_kernel": ("FOLD", "EXT"),
    "rwmh_step_kernel": ("EXT",),
    "logp_grad_kernel": ("HESS",),
    "loglik_kernel": (),
    "segment_kernel": ("GRAD",),
    "philox_fill_kernel": (),
}
_NAME = re.compile(r"(\w+_kernel)\s*<([^>]*)>")


def kernel_work(kernel: str, C: int, G: int, n: int, p: int,
                noise: bool = False, fold: bool = False) -> tuple:
    """(bytes, float32 operations) one call of ``kernel`` needs on (C, G)
    cells of n observations and p covariates: the data x, y, mask once,
    each per-cell input and output once (external noise when ``noise``;
    the (2, G, p, C) R-hat accumulators read and written when ``fold``);
    per obs-cell 2p (eta) + 9 (logistic value terms) [+ 2p + 8 (gradient
    terms)] [+ 3T (Hessian)] operations, per cell the step's own algebra.
    ``kernel``: loglik, logp_grad, logp_grad_hess, rwmh_step, mala_step,
    newton_step (refresh) or newton_step_frozen."""
    T = p * (p + 1) // 2
    cells, obs = C * G, C * G * n
    data = 4 * G * n * (p + 2)
    hyper = 8 * C * p
    f = 4 * 2 * G * p * C if fold else 0
    nz = 4 * cells * (p + 1) if noise else 0
    val_ops = 2 * p + 9
    grad_ops = val_ops + 2 * p + 8
    hess_ops = 3 * T
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
    if kernel in ("newton_step", "newton_step_frozen"):
        frozen = kernel == "newton_step_frozen"
        h = 0 if frozen else 4 * cells * T
        return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4 + T) + h,
                obs * (grad_ops + (0 if frozen else hess_ops))
                + cells * (4 * p ** 3 + 30 * p + (8 * p if fold else 0)))
    raise KeyError(kernel)


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time in ms the card could take for the work: the larger of
    the bytes over HBM_BPS and the operations over FP32_OPS."""
    return max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3


def classify(name: str) -> str:
    """'nccl', 'kernels' (the program's hand-written kernels) or 'plain'
    (every other device operation: PyTorch's kernels, copies, fills)."""
    if name.startswith(("ncclKernel", "ncclDevKernel")) or "nccl" in name[:12]:
        return "nccl"
    if any(k in name for k in HAND_WRITTEN):
        return "kernels"
    return "plain"


def kernel_call(name: str) -> tuple | None:
    """(kernel_work name, noise, fold) of a hand-written kernel's device
    name, read from the template arguments the profiler prints with it;
    None for a kernel whose work this file does not count (the Poisson
    family, the segment pass, the noise fill) or a name without them."""
    m = _NAME.search(name)
    if m is None or m.group(1) not in HAND_WRITTEN:
        return None
    base = m.group(1)
    args = [a.strip() for a in m.group(2).split(",")]
    names = HAND_WRITTEN[base]
    if "Logit" not in args[0] or len(args) != 2 + len(names):
        return None
    flags = {k: v == "true" for k, v in zip(names, args[2:])}
    if base == "newton_step_kernel":
        return ("newton_step_frozen" if flags["FROZEN"] else "newton_step",
                flags["EXT"], flags["FOLD"])
    if base == "mala_step_kernel":
        return ("mala_step", flags["EXT"], flags["FOLD"])
    if base == "rwmh_step_kernel":
        return ("rwmh_step", flags["EXT"], False)
    if base == "logp_grad_kernel":
        return ("logp_grad_hess" if flags["HESS"] else "logp_grad", False,
                False)
    if base == "loglik_kernel":
        return ("loglik", False, False)
    return None
