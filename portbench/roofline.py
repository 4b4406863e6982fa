"""The yardstick of the kernels: the card's published peaks, the least time
a piece of work needs on it, and the names by which the profiler shows the
program's hand-written kernels. The work of each launch is counted by the
model's module (portbench/models/<model>.py), from a frozen copy of the
program's per-call counts."""

from __future__ import annotations

import re

# NVIDIA H100 80GB HBM3 (SXM) at 700 W, NVIDIA's data sheet: HBM3 bandwidth
# and the float32 rate outside the tensor cores
HBM_BPS = 3.35e12
FP32_OPS = 67e12

# the __global__ templates of the program's CUDA step and likelihood
# sources and their template parameters after (family, P); a model's module
# names the kernels of its own besides these. NCCL's kernels are named
# ncclKernel* or ncclDevKernel*
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


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time in ms the card could take for the work: the larger of
    the bytes over HBM_BPS and the operations over FP32_OPS."""
    return max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3


def classify(name: str, extra=()) -> str:
    """'nccl', 'kernels' (the program's hand-written kernels: those of
    HAND_WRITTEN and the model's ``extra`` names) or 'plain' (every other
    device operation: PyTorch's kernels, copies, fills)."""
    if name.startswith(("ncclKernel", "ncclDevKernel")) or "nccl" in name[:12]:
        return "nccl"
    if any(k in name for k in HAND_WRITTEN) or any(k in name for k in extra):
        return "kernels"
    return "plain"


def template(name: str) -> tuple | None:
    """(template, family, {parameter: bool}) of a HAND_WRITTEN kernel's
    device name, read from the template arguments the profiler prints with
    it; None for another kernel or a name without them."""
    m = _NAME.search(name)
    if m is None or m.group(1) not in HAND_WRITTEN:
        return None
    base = m.group(1)
    args = [a.strip() for a in m.group(2).split(",")]
    names = HAND_WRITTEN[base]
    if len(args) != 2 + len(names):
        return None
    return base, args[0], {k: v == "true" for k, v in zip(names, args[2:])}
