"""What a rank of a sharded run holds, and the noise fill that lets it.

Two gloo ranks, spawned once (tests/_torch_dist_worker.py, mode 'share'):
a chain-sharded run keeps only the rank's part of its final carry and
acceptance rates (Posterior.final_state, accept_rates), and
parallel.gather_state gives the unsharded run's carry back bit for bit;
its checkpoints, gathered to the primary alone, hold the unsharded run's
arrays bit for bit, and an allocation audit shows that only the primary
ever formed the carry at its global extents, inside that gather; a
group-sharded run's parts have the group span; warmup_then_state's rank
part starts a sampling run as its gathered carry does.

The fill (ops/cuda/philox_fill, plain version on the CPU): a chain slice,
a unit slice and a block of it equal that slice of the whole fill bit for
bit, SweepRNG's unit-axis draws on a shard are the unsharded draws' slice,
and its normals and uniforms pass Kolmogorov-Smirnov tests at n = 1e6.
"""

import os

import numpy as np
import pytest
import scipy.stats
import torch

from nestmc_torch import sample
from nestmc_torch.checkpoint import latest_tag
from nestmc_torch.ops.cuda.philox_fill import MODES, philox_fill_plain
from nestmc_torch.rng import SweepRNG
from tests._torch_dist_worker import (
    SHARE_C,
    SHARE_G,
    _leaves,
    share_case,
    share_cfg,
    spawn,
)
from tests.test_torch_calibration import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("share")
    return spawn("share", tmp), tmp


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The unsharded run of the share mode, with its checkpoints."""
    ck = tmp_path_factory.mktemp("share_unsharded")
    model, data = share_case()
    return sample(model, data, share_cfg(1, 1, str(ck))), ck


def test_final_state_is_the_rank_part(ranks):
    out, _ = ranks
    half = SHARE_C // 2
    for _, sc in out:
        assert sc["chains_final_shape_beta"] == [half, SHARE_G, 3]
        assert sc["chains_final_shape_mu"] == [half, 3]
        assert sc["chains_accept_shape_beta"] == [half, SHARE_G]
        assert sc["groups_final_shape_beta"] == [SHARE_C, SHARE_G // 2, 3]
        assert sc["groups_final_shape_mu"] == [SHARE_C, 3]
        assert sc["part_beta_shape"] == [half, SHARE_G, 3]


def test_gather_state_is_the_unsharded_carry(ranks, unsharded):
    out, _ = ranks
    post, _ = unsharded
    want = dict(_leaves(post.final_state))
    assert len(want) > 5
    for arrays, sc in out:
        for path, t in want.items():
            np.testing.assert_array_equal(arrays[f"chains_final{path}"],
                                          t.numpy(), err_msg=path)
        np.testing.assert_array_equal(arrays["chains_draws_mu"],
                                      post.draws["mu"].numpy())
        for k, v in post.accept_rates.items():
            # a float64 sum over the ranks against float32 mean(): the
            # same value up to float32 rounding
            assert sc[f"chains_accept_mean_{k}"] == pytest.approx(
                float(v.mean()), rel=1e-6), k
    # the group-split parts gathered: the global shapes
    for path, t in want.items():
        assert out[0][0][f"groups_final{path}"].shape == tuple(t.shape)


def test_checkpoints_are_the_unsharded_runs(ranks, unsharded):
    """Every checkpoint the two ranks wrote (the primary alone) holds the
    unsharded run's arrays at the same count, bit for bit, and resume
    finds the same newest one."""
    _, tmp = ranks
    _, ck_u = unsharded
    ck = tmp / "ck"
    names = sorted(os.listdir(ck))
    assert names == sorted(os.listdir(ck_u))
    tags = [n[len("carry_"):-len(".npz")] for n in names
            if n.startswith("carry_")]
    assert len(tags) == 2 + 3          # warmup 3 + 1, draws 3 x 3
    assert latest_tag(str(ck)) == latest_tag(str(ck_u))
    for tag in tags:
        with np.load(ck / f"carry_{tag}.npz") as a, \
                np.load(ck_u / f"carry_{tag}.npz") as b:
            assert a.files == b.files
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f], err_msg=(tag, f))


def test_only_the_primary_held_the_carry_whole(ranks):
    """The audit covers the whole run, its five checkpoints included: the
    second rank never made a tensor with both the global chain and group
    extents; the primary made them only inside the gather of a checkpoint
    to it."""
    out, _ = ranks
    a0, a1 = out[0][1]["audit"], out[1][1]["audit"]
    for a in (a0, a1):
        assert a["ops"] > 100
    assert a1["n_global"] == 0, a1["outside"]
    assert a0["outside"] == [] and a0["n_inside"] > 0


def test_a_rank_part_resumes_as_the_global_carry(ranks):
    out, _ = ranks
    for arrays, _ in out:
        np.testing.assert_array_equal(arrays["resume_part_mu"],
                                      arrays["resume_whole_mu"])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fill_slices_are_slices_of_the_whole(mode):
    key = torch.tensor([-123456789, 987654321], dtype=torch.int32)
    C, U = 9, 11
    whole = philox_fill_plain((C, U, 3), key, 0, 0, U, mode)
    assert whole.shape == (C, U, 3)
    chains = philox_fill_plain((4, U, 3), key, 5, 0, U, mode)
    assert torch.equal(chains, whole[5:9])
    units = philox_fill_plain((C, 6, 3), key, 0, 3, U, mode)
    assert torch.equal(units, whole[:, 3:9])
    block = philox_fill_plain((2, 5, 3), key, 1, 6, U, mode)
    assert torch.equal(block, whole[1:3, 6:11])
    # no trailing dims: (C, U)
    flat = philox_fill_plain((C, U), key, 0, 0, U, mode)
    assert torch.equal(philox_fill_plain((C, 4), key, 0, 7, U, mode),
                       flat[:, 7:])


def test_sweep_rng_fill_is_the_unsharded_draws_slice():
    """SweepRNG's unit-axis draws on a rank holding chains 3.. and units
    2..6 of (8, 9, 2) are the unsharded draws' block; both take one key
    pair a draw, so the generators stay equal."""
    whole, part = SweepRNG(4, "cpu"), SweepRNG(4, "cpu")
    part.chains = (3, 8)
    for _ in range(2):
        n = whole.normal((8, 9, 2), units=(1, 0, None))
        lu = whole.log_uniform((8, 9), units=(1, 0, None))
        assert torch.equal(part.normal((5, 4, 2), units=(1, 2, 9)),
                           n[3:, 2:6])
        assert torch.equal(part.log_uniform((5, 4), units=(1, 2, 9)),
                           lu[3:, 2:6])
    for k, st in whole.get_state().items():
        assert torch.equal(part.get_state()[k], st), k


@pytest.mark.parametrize("mode", ["normal", "uniform"])
def test_fill_passes_ks_at_a_million(mode):
    key = torch.tensor([2024, 1018], dtype=torch.int32)
    x = philox_fill_plain((1000, 1000), key, 0, 0, 1000, mode).double()
    x = x.reshape(-1).numpy()
    dist = "norm" if mode == "normal" else "uniform"
    p = scipy.stats.kstest(x, dist).pvalue
    assert p > 1e-3, p
    if mode == "uniform":
        assert x.min() > 0.0 and x.max() < 1.0
