"""Sharding on torch.distributed: twins of tests/test_sharding.py's five
tests, run by two gloo ranks on the CPU (one spawn, tests/
_torch_dist_worker.py), plus the port's own: group-sharded ragged data
(both routes), eight schools, the conjugate model and a vmap_chains user
model sweep as the unsharded run does, groups_sum over two ranks is the
plain sum, and the six fused steps' plain versions at chain and unit
offsets give a slice of the full call bitwise (what rng.py and the
kernels' Philox counters promise).

The population conditionals and the joint on group-sharded state, padded
and ragged, are held to the JAX package's unsharded ones on the same
numpy state.
"""

import numpy as np
import pytest
import torch

import jax

from nestmc.data import RaggedData as JRaggedData
from nestmc.models import make_hier_logistic as j_make_hier_logistic
from nestmc.models import synth_logistic as j_synth_logistic
from nestmc_torch import RunConfig, SamplerConfig, ShardingConfig, sample
from nestmc_torch.data import from_numpy_ragged
from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.parallel import make_mesh
from nestmc_torch.rng import SweepRNG
from tests._torch_dist_worker import (
    MESH22_CASES,
    _cfg,
    ragged_case,
    setup_cases,
    spawn,
    sweep_cases,
    sweep_pair,
)
from tests._torch_steps import STEPS, cut_inputs, run_step, step_inputs
from tests.test_torch_calibration import one_thread  # noqa: F401


def _state(C=16, G=32, p=3, seed=0):
    r = np.random.default_rng(seed)
    return {
        "beta": (0.5 * r.standard_normal((C, G, p))).astype(np.float32),
        "mu": (0.5 * r.standard_normal((C, p))).astype(np.float32),
        "log_tau": (-0.5 + 0.3 * r.standard_normal((C, p))).astype(
            np.float32),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of the 'sharding' mode, and its inputs."""
    tmp = tmp_path_factory.mktemp("sharding")
    jdata, _ = j_synth_logistic(jax.random.key(5), G=32, n=8, p=3)
    inp = {"x": np.asarray(jdata.x), "y": np.asarray(jdata.y),
           "mask": np.asarray(jdata.mask), **_state()}
    G = ragged_case()[3]
    inp.update({"r_" + k: v for k, v in _state(G=G, p=2, seed=4).items()})
    np.savez(tmp / "in.npz", **inp)
    return spawn("sharding", tmp), jdata, inp


def test_pop_block_cond_matches_across_shardings(ranks):
    """The conditionals of mu and log_tau and the joint, evaluated on
    group-sharded state (each rank holds 16 of the 32 groups; the sums
    over groups are all_reduces), equal the JAX package's unsharded
    evaluation on the same state."""
    out, jdata, inp = ranks
    model = j_make_hier_logistic(jdata, loglik_impl="jnp")
    pos = {k: jax.numpy.asarray(inp[k]) for k in ("beta", "mu", "log_tau")}
    refs = {
        "cond_mu": model.cond_logdensity("mu", pos["mu"], pos, jdata),
        "cond_log_tau": model.cond_logdensity("log_tau", pos["log_tau"],
                                              pos, jdata),
        "joint": model.joint_logdensity(pos, jdata),
    }
    for arrays, _ in out:
        for k, ref in refs.items():
            np.testing.assert_allclose(arrays[k], np.asarray(ref),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # replicated blocks stay bitwise equal across the group shards
    for k in refs:
        np.testing.assert_array_equal(out[0][0][k], out[1][0][k])


@pytest.mark.parametrize("impl", ["bucket", "pallas-segment"])
def test_ragged_pop_block_cond_matches_across_shardings(ranks, impl):
    """Ragged data on each route, the groups (and their observation rows)
    split over the two ranks: the conditionals of mu and log_tau and the
    joint equal the JAX package's unsharded evaluation (loglik_impl
    'jnp') on the same numpy data and state, bitwise equal on both ranks;
    the gathered group_loglik equals the port's unsharded one."""
    out, _, inp = ranks
    x, y, seg, G = ragged_case()
    jdata = JRaggedData(y=jax.numpy.asarray(y),
                        segment_ids=jax.numpy.asarray(seg, np.int32),
                        num_groups=G, x=jax.numpy.asarray(x))
    model = j_make_hier_logistic(jdata, loglik_impl="jnp")
    pos = {k: jax.numpy.asarray(inp["r_" + k])
           for k in ("beta", "mu", "log_tau")}
    refs = {
        "cond_mu": model.cond_logdensity("mu", pos["mu"], pos, jdata),
        "cond_log_tau": model.cond_logdensity("log_tau", pos["log_tau"],
                                              pos, jdata),
        "joint": model.joint_logdensity(pos, jdata),
    }
    rdata = from_numpy_ragged(x, y, seg, G, device="cpu")
    tmodel = make_hier_logistic(rdata, loglik_impl=impl)
    gll = tmodel.derived["group_loglik"](
        {k: torch.from_numpy(inp["r_" + k]) for k in ("beta",)})
    offsets = np.searchsorted(seg, np.arange(G + 1))
    for rank, (arrays, sc) in enumerate(out):
        for k, ref in refs.items():
            np.testing.assert_allclose(arrays[f"ragged_{impl}_{k}"],
                                       np.asarray(ref), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(arrays[f"ragged_{impl}_group_loglik"],
                                   gll.numpy(), rtol=1e-5, atol=1e-5)
        g0, g1 = (0, G // 2) if rank == 0 else (G // 2, G)
        assert sc[f"ragged_{impl}_obs_span"] == [
            int(offsets[g0]), int(offsets[g1] - offsets[g0]), len(y)]
    for k in refs:
        np.testing.assert_array_equal(out[0][0][f"ragged_{impl}_{k}"],
                                      out[1][0][f"ragged_{impl}_{k}"])


def test_ragged_group_sharded_run(ranks):
    """A group-sharded ragged run collecting groups by index and the
    first 30 group_loglik columns: the draws are gathered in the global
    layout on both ranks (the picked groups are global ids, across the
    shards), the last draw of the picks is the final carry's columns, and
    mu is bitwise equal on both ranks."""
    out, _, _ = ranks
    G = ragged_case()[3]
    for arrays, _ in out:
        assert arrays["ragged_run_mu"].shape == (8, 12, 2)
        assert arrays["ragged_run_beta"].shape == (8, 12, 4, 2)
        assert arrays["ragged_run_group_loglik"].shape == (8, 12, 30)
        assert arrays["ragged_run_final_beta"].shape == (8, G, 2)
        for v in (arrays[k] for k in arrays if k.startswith("ragged_run")):
            assert np.all(np.isfinite(v))
        np.testing.assert_array_equal(
            arrays["ragged_run_beta"][:, -1],
            arrays["ragged_run_final_beta"][:, [1, 38, 25, 3]])
    for k in ("mu", "beta", "group_loglik", "final_beta"):
        np.testing.assert_array_equal(out[0][0][f"ragged_run_{k}"],
                                      out[1][0][f"ragged_run_{k}"])


@pytest.mark.parametrize("case", [c[0] for c in sweep_cases()])
def test_group_sharded_sweeps_match_unsharded(ranks, case):
    """Two sweeps (warmup, then sampling) of every model that declares
    unit axes, by each algorithm, on group-sharded state equal the
    unsharded sweeps from the same carry and noise up to the summation
    order of the sums over groups: a sum that missed groups_sum would
    move every population block. The population blocks are bitwise equal
    on both ranks, and both ranks' generators end where the unsharded
    run's do (each draws every tensor, and every skipped bucket's noise,
    at its global shape)."""
    out, _, _ = ranks
    _, model, data, alg = next(c for c in sweep_cases() if c[0] == case)
    ref, rng = sweep_pair(model, data, alg, with_rng=True)
    for k, v in rng.get_state().items():
        for arrays, _ in out:
            np.testing.assert_array_equal(arrays[f"sweep_{case}_rng_{k}"],
                                          v.numpy(), err_msg=k)
    for arrays, _ in out:
        for k, v in ref.position.items():
            np.testing.assert_allclose(arrays[f"sweep_{case}_{k}"],
                                       v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        for k, v in ref.accept_sum.items():
            np.testing.assert_allclose(arrays[f"sweep_{case}_accept_{k}"],
                                       v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    for k in ref.position:
        np.testing.assert_array_equal(out[0][0][f"sweep_{case}_{k}"],
                                      out[1][0][f"sweep_{case}_{k}"])


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    return spawn("mesh22", tmp_path_factory.mktemp("mesh22"), nproc=4)


@pytest.mark.parametrize("case", MESH22_CASES)
def test_two_by_two_mesh_sweeps_match_unsharded(mesh22, case):
    """Four ranks, chains and groups both split: the noise is the global
    draws' slice on both axes, the gathers sum over all four ranks; the
    sweeps equal the unsharded ones up to the summation order, and each
    chain shard's two group shards hold the same mu bits."""
    _, model, data, alg = next(c for c in sweep_cases() if c[0] == case)
    ref = sweep_pair(model, data, alg)
    for arrays, _ in mesh22:
        for k, v in ref.position.items():
            np.testing.assert_allclose(arrays[f"sweep_{case}_{k}"],
                                       v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    by_chain = {}
    for arrays, sc in mesh22:
        by_chain.setdefault(sc["chain_index"], []).append(
            arrays[f"local_{case}_mu"])
    assert sorted(by_chain) == [0, 1]
    for a, b in by_chain.values():
        np.testing.assert_array_equal(a, b)


def test_state_sharding_placement(ranks):
    out, _, inp = ranks
    for rank, (arrays, sc) in enumerate(out):
        assert sc["spec_beta"] == ["chains", "groups"]
        assert sc["spec_mu"] == ["chains"]
        assert sc["spec_x"] == ["groups"]
        assert sc["beta_shape"] == [16, 16, 3]
        assert sc["cache_shape"] == [16, 16]
        assert sc["mu_shape"] == [16, 3]
        assert sc["x_shape"] == [16, 8, 3]
        np.testing.assert_array_equal(
            arrays["beta_local"], inp["beta"][:, 16 * rank:16 * rank + 16])
        np.testing.assert_array_equal(arrays["gathered_beta"], inp["beta"])


def test_nested_poisson_sharded_run(ranks):
    """Three-level model with subjects and groups split over the group
    shards (whole groups on each): finite draws, gathered to the global
    layout on both ranks, the replicated mu bitwise equal across them."""
    out, _, _ = ranks
    for arrays, sc in out:
        assert arrays["np_mu"].shape == (8, 30, 2)
        assert arrays["np_beta_s"].shape == (8, 30, 3, 2)
        assert np.all(np.isfinite(arrays["np_mu"]))
        assert np.all(np.isfinite(arrays["np_beta_s"]))
        assert sc["np_final_beta_s"] == [8, 32, 2]
    np.testing.assert_array_equal(out[0][0]["np_mu"], out[1][0]["np_mu"])


def test_ragged_chain_sharded_run(ranks):
    """Ragged data shard chains: the draws are the unsharded run's."""
    out, _, _ = ranks
    data, _ = synth_logistic(7, G=40, n=12, p=2, ragged=True, device="cpu")
    post = sample(make_hier_logistic(data), data,
                  _cfg(16, 30, 30, collect={"mu": None}))
    for arrays, _ in out:
        assert np.all(np.isfinite(arrays["ragged_mu"]))
        np.testing.assert_array_equal(arrays["ragged_mu"],
                                      post.draws["mu"].numpy())


def test_groups_sum_is_the_plain_sum(ranks):
    out, _, _ = ranks
    for arrays, _ in out:
        np.testing.assert_allclose(arrays["groups_sum"], arrays["plain_sum"],
                                   rtol=1e-6, atol=1e-6)


def test_mesh_size_validation():
    cfg = SamplerConfig(
        sharding=ShardingConfig(chain_shards=64, group_shards=2))
    with pytest.raises(ValueError, match="devices"):
        make_mesh(cfg)
    assert make_mesh(SamplerConfig(run=RunConfig(chains=4))) is None


@pytest.mark.parametrize("name", STEPS)
def test_plain_steps_at_offsets_slice_the_full_call(name):
    """A step on chains 3..7 of 8 or units 5..11 of 12, given the offsets
    (the rng's chains, the units argument), equals that slice of the
    full-width call bitwise: the noise is the full call's."""
    a = step_inputs(8, 12, 6, 3, name, "cpu")
    full = run_step(name, a, SweepRNG(5, "cpu"))
    for cs, us in ((slice(3, 8), slice(None)), (slice(None), slice(5, 12))):
        part = run_step(name, cut_inputs(a, cs, us), SweepRNG(5, "cpu"),
                        cs, us, 8, 12)
        for f, q in zip(full, part):
            torch.testing.assert_close(q, f[cs, us], rtol=0, atol=0)


def _setup_names():
    return [c[0] for c in setup_cases()]


@pytest.mark.parametrize("split", ["groups", "chains"])
@pytest.mark.parametrize("case", _setup_names())
def test_rank_setup_carry_is_the_cut_of_the_global_one(ranks, case, split):
    """Each rank builds its part of the initial carry on its own
    (sharding.shard_state: the positions drawn at their global shapes and
    cut, the scales, acceptance sums, preconditioner moments and caches
    from the cut positions on the rank's data): bitwise the cut of the
    unsharded init_kernel_state, every leaf, with the groups or the chains
    split over the two ranks."""
    out, _, _ = ranks
    for arrays, sc in out:
        got = sc[f"setup_{split}_{case}"]
        assert got["leaves"] >= 3
        assert got["differ"] == [], got["differ"]


def _audits(out, prefix):
    return [(k, v) for _, sc in out for k, v in sc.items()
            if k.startswith(prefix)]


@pytest.mark.parametrize("split", ["groups", "chains", "mesh22"])
def test_no_rank_allocates_at_the_global_extents(ranks, mesh22, split):
    """The allocation audit (tests/_torch_dist_worker._Audit, a
    TorchDispatchMode): outside SweepRNG's draws and the model's position
    draw, no op a rank runs in a short full_rhat run makes a tensor with
    both the global chain extent and a global unit extent: from
    sample()'s entry to the final gathers when the groups are split (two
    group shards, with one and with two chain shards), through the last
    sweep when only the chains are. Padded hier_logistic on each
    algorithm, nested_poisson and both ragged routes."""
    out = mesh22 if split == "mesh22" else ranks[0]
    audits = _audits(out, f"audit_{split}_")
    assert len(audits) >= (3 if split == "mesh22" else 6) * len(out) // 2
    for k, a in audits:
        assert a["ended"] and a["ops"] > 100, (k, a)
        assert a["n_global"] == 0, (k, a["n_global"], a["global"])


@pytest.mark.parametrize("split", ["groups", "mesh22"])
def test_sharded_rhat_maps_equal_the_gathered_finalize(ranks, mesh22, split):
    """A group-sharded run finalizes its streamed R-hat and ESS where its
    units live (its own accumulators with one chain shard; slices of its
    units gathered over the chain shards on the 2 x 2 mesh) and gathers
    only the maps: they equal the maps of the accumulators gathered to the
    global layout and finalized whole, to 1e-6 relative. The finalize
    reduces over the chains alone, but PyTorch picks a reduction's
    summation order by the tensor's extents, so a part's maps may differ
    from the whole's in the last bits (2.2e-07 relative at worst here)."""
    out = mesh22 if split == "mesh22" else ranks[0]
    n = 0
    for arrays, _ in out:
        pre = f"rhat_{split}_"
        for k in arrays:
            if k.startswith(pre) and ".ref." not in k:
                name, rest = k.split(".", 1)
                ref = arrays[f"{name}.ref.{rest}"]
                assert arrays[k].shape == ref.shape, k
                np.testing.assert_allclose(arrays[k], ref, rtol=1e-6,
                                           atol=0, err_msg=k)
                n += 1
    assert n >= 3 * 3 * len(out)
