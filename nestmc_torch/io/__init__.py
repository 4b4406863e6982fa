"""Data loaders (port of :mod:`nestmc.io`)."""

from nestmc_torch.io.loaders import load_csv

__all__ = ["load_csv"]
