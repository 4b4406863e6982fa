"""Same seed => bitwise-identical draws (twin of the unsharded half of
tests/test_determinism.py: G=16, n=12, p=2, 16 chains, 60/60, seeds 9 and
10). The port's noise comes from the run's SweepRNG alone (no global
RNG), and its reductions have a fixed order, so a second run at the same
seed repeats every bit; another seed moves mu. Run here on the CPU (plain
versions of the kernels, the reference's RW-MH default) and, for the fused
steps' plain versions, with Newton-MH and MALA; chip_smoke.py phase 9c
holds the kernels on the card to the same.

The sharded pair runs two gloo ranks (one spawn, tests/
_torch_dist_worker.py): chains split over them give the unsharded draws
bitwise (every rank draws the global noise and keeps its chains); groups
split give the same posterior up to the summation order of the sums over
groups. A checkpoint of the chain-sharded run holds the global carry, and
an unsharded resume from it repeats the uninterrupted run's draws.
"""

import os

import numpy as np
import pytest

from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
from nestmc_torch.checkpoint import checkpoint_tag
from nestmc_torch.cli import _load_resume
from nestmc_torch.models import make_hier_logistic, synth_logistic
from tests._torch_dist_worker import _cfg, spawn
from tests.test_torch_calibration import one_thread  # noqa: F401


def _run(seed=9, algorithm="rwmh"):
    data, _ = synth_logistic(21, G=16, n=12, p=2, device="cpu")
    model = make_hier_logistic(data)
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(chains=16, warmup=60, draws=60, seed=seed,
                      log_every_segment=False),
    )
    return sample(model, data, cfg)


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton"])
def test_same_seed_bitwise_identical(algorithm):
    a = _run(algorithm=algorithm)
    b = _run(algorithm=algorithm)
    assert set(a.draws) == set(b.draws)
    for k in a.draws:
        np.testing.assert_array_equal(a.draws[k].numpy(), b.draws[k].numpy(),
                                      err_msg=k)


def test_different_seed_differs():
    a = _run(seed=9)
    b = _run(seed=10)
    assert not np.array_equal(a.draws["mu"].numpy(), b.draws["mu"].numpy())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("determinism")
    return spawn("determinism", tmp), tmp


@pytest.mark.parametrize("algorithm", ["rwmh", "newton"])
def test_chain_sharded_matches_unsharded(ranks, algorithm):
    """Chain-axis sharding must not change a single bit of the draws."""
    out, _ = ranks
    a = _run(algorithm=algorithm)
    for arrays, _ in out:
        for k, v in a.draws.items():
            np.testing.assert_array_equal(
                arrays[f"chains_{algorithm}_{k}"], v.numpy(), err_msg=k)


def test_group_sharded_statistically_identical(ranks):
    """Group-axis sharding changes the summation order of the sums over
    groups, so bits may differ; acceptance rates and the posterior of mu
    must agree (the reference's bounds)."""
    out, _ = ranks
    data, _ = synth_logistic(21, G=16, n=12, p=2, device="cpu")
    a = sample(make_hier_logistic(data), data, _cfg(32, 60, 60, seed=9))
    for _, sc in out:
        for k, v in a.accept_rates.items():
            assert abs(float(v.mean()) - sc[f"groups_accept_{k}"]) < 0.15, k
    mb = out[0][0]["groups_mu_mean"]
    assert np.all(np.abs(a.draws["mu"].mean(dim=(0, 1)).numpy() - mb) < 1.0)
    np.testing.assert_array_equal(mb, out[1][0]["groups_mu_mean"])


def test_sharded_checkpoint_resumes_unsharded(ranks):
    """The 2-rank chain-sharded run wrote its checkpoints (primary only,
    the gathered carry); dropping the last sample checkpoint and resuming
    from the one before, unsharded, gives the uninterrupted run's last
    draws bitwise and its streamed R-hat."""
    out, tmp = ranks
    ck = tmp / "ck"
    tags = sorted(f[len("meta_"):-len(".json")] for f in os.listdir(ck)
                  if f.startswith("meta_sample_"))
    assert tags == [checkpoint_tag("sample", n) for n in (20, 40, 60)]
    for f in (f"meta_{tags[-1]}.json", f"carry_{tags[-1]}.npz"):
        os.remove(ck / f)
    data, _ = synth_logistic(21, G=16, n=12, p=2, device="cpu")
    model = make_hier_logistic(data)
    cfg = _cfg(16, 40, 60, seed=9, segment_size=20, full_rhat=True,
               checkpoint_dir=str(ck), checkpoint_every=1)
    kw = _load_resume(model, data, cfg)
    assert kw["draws_offset"] == 40
    post = sample(model, data, cfg, **kw)
    np.testing.assert_array_equal(post.draws["mu"].numpy(),
                                  out[0][0]["ck_mu"][:, 40:])
    full = sample(model, data, _cfg(16, 40, 60, seed=9, segment_size=20,
                                    full_rhat=True))
    for k, v in full.full_rhat.items():
        np.testing.assert_array_equal(post.full_rhat[k].numpy(),
                                      v.numpy(), err_msg=k)
