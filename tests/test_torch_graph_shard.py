"""Captured steps of sharded runs (nestmc_torch/segments.py) on the CPU.

The loop a run takes is decided before it, by segments.capturable, from
the device, the mesh and the backend: these tests pass fake devices and
backends, so nothing here needs a card. The parts of a captured step that
are host logic run here too: the groups_sum timing guard inside a
capture, the host counts a replay repeats (kernel launches and
collective calls), and the ranks' lockstep check before a segment's
replays, with a fake graph in place of a captured one.
tests/test_torch_cuda.py runs two ranks on the card; chip_smoke.py's
phase 10 runs four, NCCL.
"""

import pytest
import torch
import torch.distributed as dist

from nestmc_torch import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.kernels.gibbs import make_sweep
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.ops.cuda import LAUNCHES, reset_launch_counts
from nestmc_torch.parallel import collectives
from nestmc_torch.parallel.collectives import STATS, Shard, activate
from nestmc_torch.parallel.sharding import Mesh
from nestmc_torch.rng import SweepRNG
from nestmc_torch.segments import WarmupProgram, capturable
from tests.test_torch_calibration import one_thread  # noqa: F401

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
CHAINS, GROUPS = Mesh(2, 1, 0), Mesh(1, 2, 0)


@pytest.mark.parametrize("device,mesh,backend,eager,graph", [
    (CPU, None, None, False, False),            # the CPU
    (CPU, GROUPS, "gloo", False, False),
    (CUDA, None, None, False, True),            # unsharded on a card
    (CUDA, CHAINS, "gloo", False, True),        # chains only, over gloo
    (CUDA, Mesh(4, 1, 3), "gloo", False, True),
    (CUDA, GROUPS, "gloo", False, False),       # groups split over gloo
    (CUDA, Mesh(2, 2, 1), "gloo", False, False),
    (CUDA, GROUPS, "nccl", False, True),        # groups split over NCCL
    (CUDA, Mesh(2, 2, 3), "nccl", False, True),
    # a vmap_chains model's group shards gather the unit axis
    # (collectives.groups_gather): a collective like groups_sum's
    ("cuda:1", GROUPS, "gloo", False, False),
    (CUDA, None, None, True, False),            # _eager
    (CUDA, CHAINS, "gloo", True, False),
    (CUDA, GROUPS, "nccl", True, False),
], ids=["cpu", "cpu-groups", "card", "chains-gloo", "chains4-gloo",
        "groups-gloo", "mesh22-gloo", "groups-nccl", "mesh22-nccl",
        "vmap-groups-gloo", "eager", "eager-chains", "eager-groups-nccl"])
def test_capturable_decides_from_device_mesh_and_backend(device, mesh,
                                                         backend, eager,
                                                         graph):
    assert capturable(device, mesh, backend, eager) is graph


def _groups_shard():
    return Shard(mesh=GROUPS, spans={"chains": (0, 4, 4),
                                     "groups": (0, 3, 6)},
                 parts={}, data=None, local=None)


def test_timing_inside_a_capture_raises(monkeypatch):
    """collectives.TIMING synchronises around each groups_sum: inside a
    capture that raises, before any collective is issued; outside one
    the all_reduce runs and its seconds are kept."""
    calls = []
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, group=None: calls.append(t))
    monkeypatch.setattr(collectives, "TIMING", True)
    monkeypatch.setitem(STATS, "groups_sum_calls", 0)
    monkeypatch.setitem(STATS, "groups_sum_s", 0.0)
    x = torch.ones(4, 3)
    with activate(_groups_shard()):
        assert torch.equal(collectives.groups_sum(x, 1), x.sum(1))
        assert len(calls) == 1 and STATS["groups_sum_s"] > 0.0
        monkeypatch.setattr(collectives, "_capturing", lambda t: True)
        with pytest.raises(RuntimeError, match="_eager=True"):
            collectives.groups_sum(x, 1)
    assert len(calls) == 1


class _FakeGraph:
    def __init__(self, log, variant):
        self.log, self.variant = log, variant

    def replay(self):
        self.log.append(self.variant)

    def reset(self):
        pass


def _program(agree=None):
    data, _ = synth_logistic(2, G=6, n=5, p=2, device="cpu")
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(kernel=KernelConfig(algorithm="rwmh"),
                        run=RunConfig(chains=4, warmup=10, draws=0))
    state = init_kernel_state(model, cfg, SweepRNG(0, "cpu"), data)
    return WarmupProgram(make_sweep(model, cfg), state, data,
                         SweepRNG(0, "cpu"), cfg, 8, True, None, agree)


def _fake_capture(prog, log, counts, fail=False):
    """Replace the program's capture (a probe and a CUDA graph) by one
    that records ``counts`` as the step's host counts."""
    def capture(variant):
        if fail:
            raise RuntimeError("this rank's capture failed")
        prog.keys_per_sweep = 0
        prog._graphs[variant] = _FakeGraph(log, variant)
        prog._replay_counts[variant] = counts
    prog._capture = capture


def test_replays_count_the_captured_launches_and_collectives(monkeypatch):
    """Each replay adds the launches and the collective calls its capture
    counted, so a segment of n steps counts n times a step's."""
    reset_launch_counts()
    monkeypatch.setitem(STATS, "groups_sum_calls", 0)
    log = []
    prog = _program()
    _fake_capture(prog, log, {("launch", "rwmh_step"): 1,
                              ("launch", "loglik"): 2,
                              ("stat", "groups_sum_calls"): 13})
    prog.run(5)
    prog.run(3)
    assert log == [None] * 8
    assert LAUNCHES["rwmh_step"] == 8 and LAUNCHES["loglik"] == 16
    assert STATS["groups_sum_calls"] == 13 * 8
    reset_launch_counts()


def test_lockstep_runs_before_every_segment_s_replays():
    """A sharded program asks the ranks before each segment's replays,
    with this rank's failure flag and the digest of its variants."""
    seen, log = [], []

    def agree(failed, digest):
        seen.append((failed, digest, list(log)))
        return False, True

    prog = _program(agree)
    _fake_capture(prog, log, {})
    prog.run(4)
    prog.run(2)
    assert [s[0] for s in seen] == [False, False]
    # asked before the segment's replays, not after
    assert [len(s[2]) for s in seen] == [0, 4]
    assert seen[0][1] != seen[1][1]     # 4 steps' variants, then 2
    reset_launch_counts()


@pytest.mark.parametrize("others,same,match", [
    (True, True, "another rank"), (False, False, "different step variants")])
def test_lockstep_raises_when_another_rank_failed_or_differs(others, same,
                                                            match):
    log = []
    prog = _program(lambda failed, digest: (others, same))
    _fake_capture(prog, log, {})
    with pytest.raises(RuntimeError, match=match):
        prog.run(3)
    assert log == []            # nothing replayed
    reset_launch_counts()


def test_a_failed_capture_raises_its_own_error_after_telling_the_ranks():
    """A rank whose capture fails still joins the check (so the others
    raise instead of waiting in a replayed collective), then raises its
    own error: no eager retry."""
    seen, log = [], []

    def agree(failed, digest):
        seen.append(failed)
        return True, True

    prog = _program(agree)
    _fake_capture(prog, log, {}, fail=True)
    with pytest.raises(RuntimeError, match="this rank's capture failed"):
        prog.run(3)
    assert seen == [True] and log == []
    reset_launch_counts()
