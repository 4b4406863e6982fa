"""The port's top-level names against the reference's.

``nestmc/__init__.py`` exports compare, psis_loo and waic and lists them
in ``__all__``; the port must too: without the import ``from nestmc_torch
import compare`` gives the submodule, and psis_loo and waic are not
attributes of the package.
"""

import sys

import pytest

import nestmc
import nestmc_torch

# reference name -> the port's name, where the port renames one (none yet)
RENAMED: dict = {}


@pytest.mark.parametrize("name", sorted(nestmc.__all__))
def test_all_covers_reference(name):
    ours = RENAMED.get(name, name)
    assert ours in nestmc_torch.__all__, name
    assert hasattr(nestmc_torch, ours), name


def test_all_names_resolve():
    missing = [n for n in nestmc_torch.__all__
               if not hasattr(nestmc_torch, n)]
    assert not missing, missing


@pytest.mark.parametrize("name", ["compare", "psis_loo", "waic"])
def test_compare_functions_exported(name):
    fn = getattr(nestmc_torch, name)
    assert callable(fn)
    assert fn is getattr(sys.modules["nestmc_torch.compare"], name)
    ns = {}
    exec(f"from nestmc_torch import {name} as f", ns)
    assert ns["f"] is fn
