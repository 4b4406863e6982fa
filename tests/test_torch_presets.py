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


SHARDED = ("judged", "ragged-10k", "ragged-10k-newton", "ragged-10k-mala",
           "mala-100k", "mala-100k-newton")


def _world(monkeypatch, n):
    """N ranks for both packages: the reference's jax.devices() has N
    entries, the port's parallel.multihost.world_size() is N."""
    import nestmc_torch.presets as tpresets

    one = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [one] * n)
    monkeypatch.setattr(tpresets, "world_size", lambda: n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", SHARDED)
def test_sharded_presets_shard_as_the_reference(name, n, monkeypatch):
    """At N ranks each sharded preset's shards and chains are the
    reference's at N devices, at the small scale (the scale < 1 chain
    rule, 8 x max(N, 1), and gsh's rule on the reference's G)."""
    _world(monkeypatch, n)
    _, _, jcfg = jpresets.get_preset(name, scale=0.01)
    _, _, cfg = get_preset(name, device="cpu", scale=0.01)
    assert (cfg.sharding.chain_shards, cfg.sharding.group_shards) == (
        jcfg.sharding.chain_shards, jcfg.sharding.group_shards)
    assert cfg.run.chains == jcfg.run.chains
    assert cfg.sharding.chain_shards * cfg.sharding.group_shards == n


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", SHARDED)
def test_full_scale_chain_rule(name, n, monkeypatch):
    """At scale 1 (built at G=8 here): the reference's formulas,
    nestmc/presets.py: judged 1024 x N chains over N chain shards, the
    ragged presets 1024 over N, mala-100k's 512 over N / gsh chain shards
    and gsh = 2 group shards on an even N > 1 (G even)."""
    _world(monkeypatch, n)
    _, _, cfg = get_preset(name, device="cpu", groups=8)
    if name == "judged":
        want = (1024 * n, n, 1)
    elif name.startswith("ragged"):
        want = (1024, n, 1)
    else:
        gsh = 2 if n % 2 == 0 and n > 1 else 1
        want = (512, n // gsh, gsh)
    assert (cfg.run.chains, cfg.sharding.chain_shards,
            cfg.sharding.group_shards) == want


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_one_rank_presets_are_unsharded(name, monkeypatch):
    """At N = 1 (a single process) every preset is unsharded, with the
    chain counts it had before the presets sharded, and its data do not
    depend on N."""
    from nestmc_torch.config import ShardingConfig

    _world(monkeypatch, 1)
    _, data, cfg = get_preset(name, device="cpu", groups=8)
    assert cfg.sharding == ShardingConfig()
    before = {"judged": 1024, "ragged-10k": 1024, "ragged-10k-newton": 1024,
              "ragged-10k-mala": 1024, "mala-100k": 512,
              "mala-100k-newton": 512}
    if name in before:
        assert cfg.run.chains == before[name]
    _world(monkeypatch, 4)
    _, data4, cfg4 = get_preset(name, device="cpu", groups=8)
    a = data if isinstance(data, dict) else vars(data)
    b = data4 if isinstance(data4, dict) else vars(data4)
    for k, v in a.items():
        if torch.is_tensor(v):
            assert torch.equal(v, b[k]), k
    assert cfg4.run.warmup == cfg.run.warmup
