"""Models ported to PyTorch."""

from nestmc_torch.models.conjugate import (
    analytic_hier_normal_posterior,
    make_hier_normal_known_scales,
    synth_hier_normal,
)
from nestmc_torch.models.eight_schools import (
    eight_schools_data,
    make_eight_schools,
)
from nestmc_torch.models.hier_glm import make_hier_glm, synth_glm
from nestmc_torch.models.hier_logistic import make_hier_logistic, synth_logistic
from nestmc_torch.models.nested_poisson import (
    make_nested_poisson,
    synth_poisson3,
)

__all__ = [
    "analytic_hier_normal_posterior",
    "eight_schools_data",
    "make_eight_schools",
    "make_hier_glm",
    "make_hier_logistic",
    "make_hier_normal_known_scales",
    "make_nested_poisson",
    "synth_glm",
    "synth_hier_normal",
    "synth_logistic",
    "synth_poisson3",
]
