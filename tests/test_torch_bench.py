"""The port's bench: the per-chain acceptance at the worst R-hat's unit."""

from types import SimpleNamespace

import pytest
import torch

from nestmc_torch.bench import _unit_accept


def _post(rates):
    return SimpleNamespace(accept_rates=rates)


def test_unit_accept_reads_the_worst_units_column():
    rates = torch.full((6, 4), 0.9)
    rates[:, 2] = torch.tensor([0.9, 0.8, 0.05, 0.7, 0.0, 0.6])
    at = {"block": "beta", "kind": "streamed", "rhat": 1.03, "index": (2, 1)}
    got = _unit_accept(_post({"beta": rates}), at)
    assert got["min"] == 0.0 and got["max"] == pytest.approx(0.9)
    assert got["chains_below_0.1"] == 2 and got["argmin_chain"] == 4
    assert got["median"] == pytest.approx(0.6)


@pytest.mark.parametrize("at,rates", [
    (None, {}),
    ({"block": "mu", "kind": "rank", "rhat": 1.0, "index": (0,)},
     {"mu": torch.ones(4, 1)}),
    ({"block": "log_tau", "kind": "streamed", "rhat": 1.0, "index": (1,)},
     {"log_tau": torch.ones(4, 1)}),
    ({"block": "mu", "kind": "streamed", "rhat": 1.0, "index": (0,)}, {}),
])
def test_unit_accept_is_none_without_a_per_unit_block(at, rates):
    assert _unit_accept(_post(rates), at) is None
