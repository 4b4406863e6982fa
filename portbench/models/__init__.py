"""The models the benchmark runs: one module a model, found by the
``model`` key of a configuration's file, ``portbench/models/<model>.py``,
with its plain reference in a file of its own beside it
(``<model>_reference.py``, which imports nothing of the program). Adding a
model adds these two files; no other file of the benchmark names a model.

A model's module provides:

- ``data(cfg)``: the configuration's arrays, from a frozen generator;
- ``build(cfg, traffic, arrays, seed, device)``: (model, data,
  SamplerConfig) through the program's public constructors, importing the
  program inside the function;
- ``prepare(cfg)``: what has to be built or loaded before the warmup's
  clock (the program's kernels);
- ``shapes(cfg, carry)``: this process's sizes that the counts read, from
  its part of a carry;
- ``parameters(cfg)``: the parameters the streamed R-hat covers;
- ``tiny(cfg)``: the configuration cut to a size the CPU tests can run;
- the check's model-specific parts: ``KEYS`` ({noise mode: key word pairs
  a sweep takes}), ``reference(cfg, arrays, device, tf32=False)`` (the
  plain reference; ``tf32``: the control), ``outputs(ref, taken, cfg,
  device)`` (what it works out from a check.Taken: {'first', 'late',
  'warm', 'carry'}) and ``program_outputs(taken, draws)`` (the same as
  the program made them);
- the counts: ``HAND_WRITTEN`` (names of its own hand-written kernels,
  besides roofline.HAND_WRITTEN), ``launch_work(name, ordinal, cfg,
  shapes)`` ((bytes, operations) of one launch of a device kernel, the
  ordinal-th of its name in a sweep, or None) and ``sweep_work(cfg,
  shapes)`` (the least work of one sweep).
"""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(name: str):
    """The module of model ``name``."""
    if not _NAME.match(name) or name.endswith("_reference"):
        raise ValueError(f"no model module can be named {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
