"""Models ported to PyTorch."""

from nestmc_torch.models.hier_logistic import make_hier_logistic, synth_logistic
from nestmc_torch.models.nested_poisson import (
    make_nested_poisson,
    synth_poisson3,
)

__all__ = [
    "make_hier_logistic",
    "make_nested_poisson",
    "synth_logistic",
    "synth_poisson3",
]
