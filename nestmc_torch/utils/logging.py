"""Minimal structured logging: one host-side line per segment.

Port of :mod:`nestmc.utils.logging`. The hot loop never logs; the engine
logs per segment (sweeps done, sweeps a second, a checkpoint written), and
the command line sets the level (WARNING under --quiet).
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "nestmc_torch", level: int | str = logging.INFO):
    """The logger ``name`` with one stderr handler in the reference's
    format (added once), not propagating to the root logger, at
    ``level``."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level)
    return logger
