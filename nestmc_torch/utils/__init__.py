"""Utilities: the logger (logging.py) and the cost model of one sweep
(profiling.py)."""

from nestmc_torch.utils.logging import get_logger

__all__ = ["get_logger"]
