"""Models ported to PyTorch."""

from nestmc_torch.models.hier_logistic import make_hier_logistic, synth_logistic

__all__ = ["make_hier_logistic", "synth_logistic"]
