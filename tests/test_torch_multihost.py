"""The multi-process entry (nestmc_torch/parallel/multihost.py): twins of
tests/test_multihost.py.

1. Contract tests, with torch.distributed.init_process_group replaced:
   the no-op single-process path, the argument / NESTMC_* / torchrun env
   precedence, and the primary-process predicate.
2. Two executed 2-process gloo runs (one spawn, tests/
   _torch_dist_worker.py): eight schools with the chains split over the
   ranks, and the hierarchical logistic model (G=64, n=12, p=3, 8 chains,
   30/50) with the groups split, whose sums over groups are all_reduces
   every sweep. Both ranks see the same global moments, and they match a
   single-process unsharded port run of the same seed.
"""

import numpy as np
import pytest
import torch.distributed as dist

from nestmc_torch import sample
from nestmc_torch.models import (
    make_eight_schools,
    make_hier_logistic,
    synth_logistic,
)
from nestmc_torch.parallel import multihost
from tests._torch_dist_worker import _cfg, spawn
from tests.test_torch_calibration import one_thread  # noqa: F401

_ENV = ("NESTMC_COORDINATOR_ADDRESS", "NESTMC_NUM_PROCESSES",
        "NESTMC_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
        "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def captured_init(monkeypatch):
    calls = []

    def fake_init(backend=None, init_method=None, world_size=-1, rank=-1,
                  **kw):
        calls.append({"backend": backend, "init_method": init_method,
                      "world_size": world_size, "rank": rank})

    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    return calls


def test_single_host_is_noop(captured_init):
    multihost.initialize(device="cpu")
    assert captured_init == []


def test_explicit_args_forwarded(captured_init):
    multihost.initialize(coordinator_address="10.0.0.1:1234",
                         num_processes=4, process_id=2, device="cpu")
    assert captured_init == [{"backend": "gloo",
                              "init_method": "tcp://10.0.0.1:1234",
                              "world_size": 4, "rank": 2}]
    assert multihost.backend() == "gloo"


def test_env_fallbacks_parsed(captured_init, monkeypatch):
    monkeypatch.setenv("NESTMC_COORDINATOR_ADDRESS", "host0:8476")
    monkeypatch.setenv("NESTMC_NUM_PROCESSES", "8")
    monkeypatch.setenv("NESTMC_PROCESS_ID", "3")
    multihost.initialize(device="cpu")
    assert captured_init == [{"backend": "gloo",
                              "init_method": "tcp://host0:8476",
                              "world_size": 8, "rank": 3}]


def test_explicit_args_beat_env(captured_init, monkeypatch):
    monkeypatch.setenv("NESTMC_COORDINATOR_ADDRESS", "host0:8476")
    monkeypatch.setenv("NESTMC_NUM_PROCESSES", "8")
    monkeypatch.setenv("NESTMC_PROCESS_ID", "3")
    # NESTMC_* in turn beat torchrun's variables
    monkeypatch.setenv("MASTER_ADDR", "tr")
    monkeypatch.setenv("MASTER_PORT", "9")
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("RANK", "5")
    multihost.initialize(coordinator_address="file:///tmp/r",
                         num_processes=2, process_id=1, device="cpu")
    multihost.initialize(device="cpu")
    assert captured_init[0]["init_method"] == "file:///tmp/r"
    assert captured_init[0]["world_size"] == 2
    assert captured_init[0]["rank"] == 1
    assert captured_init[1]["init_method"] == "tcp://host0:8476"
    assert captured_init[1]["world_size"] == 8
    assert captured_init[1]["rank"] == 3


def test_empty_env_is_noop(captured_init, monkeypatch):
    # empty strings (common in CI templating) must not trigger init
    for var in _ENV[:3]:
        monkeypatch.setenv(var, "")
    multihost.initialize(device="cpu")
    assert captured_init == []
    # torchrun's variables alone start a group
    monkeypatch.setenv("MASTER_ADDR", "tr")
    monkeypatch.setenv("MASTER_PORT", "9")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    multihost.initialize(device="cpu")
    assert captured_init == [{"backend": "gloo", "init_method": "tcp://tr:9",
                              "world_size": 2, "rank": 1}]


def test_is_primary_single_host():
    assert multihost.is_primary() is True
    assert multihost.world_size() == 1
    assert multihost.rank() == 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, and the tmp dir they wrote to."""
    tmp = tmp_path_factory.mktemp("multihost")
    return spawn("multihost", tmp), tmp


def _moments(post):
    out = {}
    for k in ("mu", "log_tau"):
        v = post.draws[k].double()
        out[f"{k}_mean"] = float(v.mean())
        out[f"{k}_var"] = float(v.var(unbiased=False))
    return out


def _check(ranks, tag, ref):
    (_, a), (_, b) = ranks[0]
    assert {a["rank"], b["rank"]} == {0, 1}
    for s in (a, b):
        assert s["world_size"] == 2
        assert s["backend"] == "gloo"
    assert a["is_primary"] != b["is_primary"]
    for k, v in ref.items():
        # both ranks gathered the same global draws
        assert a[f"{tag}_{k}"] == pytest.approx(b[f"{tag}_{k}"], rel=1e-6)
        assert a[f"{tag}_{k}"] == pytest.approx(v, rel=1e-4, abs=1e-5), (
            k, a[f"{tag}_{k}"], v)


def test_two_process_distributed_sample(ranks):
    """Chains split over two processes: the moments are the unsharded
    single-process run's (the draws are its bits)."""
    model, data = make_eight_schools(device="cpu")
    post = sample(model, data, _cfg(8, 40, 80, seed=7, segment_size=80,
                                    collect={"mu": None, "log_tau": None}))
    _check(ranks, "chains", _moments(post))


def test_two_process_group_axis_psum(ranks):
    """Groups split over two processes: the conjugate mu / tau draws and
    the interweaving move reduce over all groups every sweep across the
    process boundary; only the f32 summation order differs from the
    unsharded single-process run."""
    data, _ = synth_logistic(9, G=64, n=12, p=3, device="cpu")
    post = sample(make_hier_logistic(data), data, _cfg(
        8, 30, 50, seed=7, segment_size=50,
        collect={"mu": None, "log_tau": None}))
    _check(ranks, "groups", _moments(post))


def test_two_process_cpu_runs_step_eagerly(ranks):
    """On the CPU a sharded run steps eagerly (segments.capturable), the
    chains split or the groups."""
    for _, s in ranks[0]:
        assert (s["chains_sweep"], s["groups_sweep"]) == ("eager", "eager")


def test_two_process_command_line(ranks, tmp_path, capsys):
    """python -m nestmc_torch run --chain-shards 2 under the 2-process
    launch: both ranks exit 0, the primary's saved draws are those of the
    single-process run; with one process the shards exit 2."""
    from nestmc_torch import cli

    out, tmp = ranks
    assert [s["cli_rc"] for _, s in out] == [0, 0]
    args = ["run", "--preset", "eight-schools", "--device", "cpu",
            "--scale", "0.05", "--quiet", "--collect", "mu,log_tau"]
    assert cli.main(args + ["--save-draws", str(tmp_path / "one.npz")]) == 0
    with np.load(tmp_path / "one.npz") as a, \
            np.load(tmp / "cli.npz") as b:
        for k in ("mu", "log_tau"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    capsys.readouterr()
    assert cli.main(args + ["--chain-shards", "2"]) == 2
    assert "devices" in capsys.readouterr().err
