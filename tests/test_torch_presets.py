"""The port's presets against the reference's.

The port has every name of nestmc.presets.PRESETS, and for each the
sampler settings both packages have agree with the reference's built for
one device: algorithm, tau prior (a conjugate log-tau draw or an MH
block), chains, warmup, draws, collect and newton_freeze. The port builds
at a small G on the CPU. Config 1 (eight-schools) and config 2
(hier-logistic-100, at G=8) also run a short schedule on the CPU through
nestmc_torch.bench.measure, the benchmark's code path.
"""

import math

import jax
import pytest
import torch

from nestmc import presets as jpresets
from nestmc_torch import bench
from nestmc_torch.presets import PRESETS, get_preset
from tests.test_torch_calibration import one_thread  # noqa: F401


def test_the_port_has_every_reference_preset():
    assert sorted(PRESETS) == sorted(jpresets.PRESETS)
    assert set(bench.TITLES) == set(PRESETS)


def _tau_draw(model):
    return any(k.startswith("log_tau") for k in model.gibbs_draws)


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_preset_settings_match_the_reference(name, monkeypatch):
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    jmodel, _, jcfg = jpresets.get_preset(name)
    model, data, cfg = get_preset(name, device="cpu", groups=8)
    assert data.num_groups == 8
    for field in ("algorithm", "newton_freeze"):
        assert getattr(cfg.kernel, field) == getattr(jcfg.kernel, field), \
            field
    for field in ("chains", "warmup", "draws", "collect"):
        assert getattr(cfg.run, field) == getattr(jcfg.run, field), field
    assert _tau_draw(model) == _tau_draw(jmodel)
    assert [b.name for b in model.blocks] == [b.name for b in jmodel.blocks]


@pytest.mark.parametrize("name,groups,n_params", [
    ("eight-schools", None, 10),
    ("hier-logistic-100", 8, 8 * 4 + 8),
])
def test_preset_runs_through_bench(name, groups, n_params):
    model, data, cfg = get_preset(name, seed=1, device="cpu", groups=groups)
    result, post, info = bench.measure(model, data, cfg, name,
                                       bench.TITLES[name], warmup=60,
                                       draws=80, full_rhat=True, seed=1)
    assert info["n_params"] == n_params
    assert result["device"] == "cpu" and result["power_limit"] is None
    assert info["peak_mem_gb_sampling"] is None
    assert math.isfinite(result["value"]) and result["value"] > 0
    covered = sum(v.numel() for v in post.full_rhat.values())
    assert covered == n_params
    for v in post.draws.values():
        assert v.shape[1] == 80 and bool(torch.isfinite(v).all())
