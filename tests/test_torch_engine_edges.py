"""Engine edge cases of the port (nestmc_torch/engine.py), on the CPU:
twins of tests/test_engine_edges.py:13-160,238 and what this slice adds.

- Segmentation, collection (derived subsets, explicit unit indices, the
  default that adds the model's derived quantities), uneven segments equal
  to one segment bitwise, warmup and sampling rates kept apart.
- The streamed split R-hat equals split_rhat of the retained draws
  (rtol 2e-4, atol 2e-4, the reference's tolerance), thinned or not, for
  an uncollected block too, and on the in-sweep fold path (MALA and
  Newton at full_rhat_thin 1) and its thinned post-sweep path.
- RunConfig.thin: each retained draw is every thin-th sweep of an
  unthinned run from the same RNG, bitwise; accept rates divide by the
  sweeps run.
- log_rhat logs the worst split R-hat of the draws so far; debug_nans
  raises at the first segment whose position holds a NaN.
- Posterior.mean, var(ddof), quantile and summarize against
  nestmc.posterior.Posterior on the same draws (rtol 1e-5, atol 1e-6;
  summarize's diagnostics rtol 1e-3, as the diagnostics parity tests).
"""

import logging
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc.posterior import Posterior as JPosterior
from nestmc_torch import sample
from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.diagnostics import split_rhat
from nestmc_torch.engine import _segments
from nestmc_torch.kernels.gibbs import rhat_fold_names
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.models import (
    make_eight_schools,
    make_hier_logistic,
    synth_logistic,
)
from tests.test_torch_calibration import one_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)


def test_segment_lengths():
    def lengths(total, seg):
        return [n for _, n in _segments(total, seg)]
    assert lengths(10, 4) == [4, 4, 2]
    assert lengths(4, 10) == [4]
    assert lengths(0, 10) == []
    assert lengths(5, 1) == [1] * 5


@pytest.fixture(scope="module")
def es():
    return make_eight_schools(device="cpu")


def _run(model, data, **run):
    kernel = run.pop("kernel", {})
    return sample(model, data, SamplerConfig(
        kernel=KernelConfig(**kernel),
        run=RunConfig(log_every_segment=run.pop("log", False), **run)))


def test_collect_derived_subset(es):
    post = _run(*es, chains=4, warmup=20, draws=30,
                collect={"mu": None, "theta": 3})
    assert post.draws["theta"].shape == (4, 30, 3)
    assert post.draws["mu"].shape == (4, 30)
    assert bool(torch.isfinite(post.draws["theta"]).all())


def test_collect_explicit_indices(es):
    post = _run(*es, chains=4, warmup=20, draws=30, seed=3,
                collect={"mu": None, "z": (5, 1, 6)})
    assert post.draws["z"].shape == (4, 30, 3)
    post_all = _run(*es, chains=4, warmup=20, draws=30, seed=3,
                    collect={"mu": None, "z": None})
    assert torch.equal(post.draws["z"], post_all.draws["z"][:, :, [5, 1, 6]])


def test_default_collect_includes_derived(es):
    post = _run(*es, chains=4, warmup=10, draws=10)
    assert set(post.draws) == {"z", "mu", "log_tau", "theta"}
    data, _ = synth_logistic(3, G=6, n=5, p=2, device="cpu")
    post = _run(make_hier_logistic(data), data, chains=4, warmup=5, draws=6)
    assert set(post.draws) == {"beta", "mu", "log_tau", "log_s2",
                               "group_loglik"}
    assert post.draws["group_loglik"].shape == (4, 6, 6)


def test_uneven_segments_match_single_segment(es):
    a = _run(*es, chains=4, warmup=24, draws=30, seed=3, segment_size=30,
             collect={"mu": None})
    b = _run(*es, chains=4, warmup=24, draws=30, seed=3, segment_size=7,
             collect={"mu": None})
    assert torch.equal(a.draws["mu"], b.draws["mu"])


def test_warmup_rates_separate_from_sampling(es):
    post = _run(*es, chains=4, warmup=50, draws=50)
    for k in post.accept_rates:
        for r in (post.warmup_accept_rates[k], post.accept_rates[k]):
            assert bool((r >= 0).all() and (r <= 1.0 + 1e-6).all())


def test_full_rhat_matches_split_rhat_of_retained_draws(es):
    post = _run(*es, chains=4, warmup=30, draws=31, segment_size=7, seed=5,
                full_rhat=True)
    assert set(post.full_rhat) == {"z", "mu", "log_tau"}
    for name, streamed in post.full_rhat.items():
        torch.testing.assert_close(streamed, split_rhat(post.draws[name]),
                                   **TOL)
    worst = max(float(split_rhat(post.draws[n]).max())
                for n in post.full_rhat)
    assert post.worst_rhat() >= worst - 1e-4


def test_full_rhat_thinned_matches_split_rhat_of_thinned_draws(es):
    k = 3
    post = _run(*es, chains=4, warmup=30, draws=50, segment_size=13, seed=5,
                full_rhat=True, full_rhat_thin=k)
    for name, streamed in post.full_rhat.items():
        torch.testing.assert_close(
            streamed, split_rhat(post.draws[name][:, ::k]), **TOL)


def test_full_rhat_uncollected_block(es):
    post = _run(*es, chains=4, warmup=20, draws=24, seed=1, full_rhat=True,
                collect={"mu": None})
    assert "z" in post.full_rhat and "z" not in post.draws
    assert bool(torch.isfinite(post.full_rhat["z"]).all())


@pytest.mark.parametrize("algorithm,rthin", [
    ("mala", 1), ("newton", 1), ("mala", 3), ("newton", 4),
])
def test_full_rhat_fold_path_matches_split_rhat(algorithm, rthin):
    """At full_rhat_thin 1 beta's R-hat folds in the fused step (one draw
    late, flushed at the end); thinned runs update after the sweep."""
    data, _ = synth_logistic(3, G=12, n=8, p=2, device="cpu")
    model = make_hier_logistic(data, tau_prior="invgamma")
    run = dict(chains=4, warmup=20, draws=50, segment_size=17, seed=9,
               full_rhat=True, full_rhat_thin=rthin,
               collect={"beta": None, "mu": None, "log_tau": None})
    cfg = SamplerConfig(kernel=KernelConfig(algorithm=algorithm),
                        run=RunConfig(log_every_segment=False, **run))
    assert rhat_fold_names(model, cfg) == (("beta",) if rthin == 1 else ())
    post = sample(model, data, cfg)
    assert set(post.full_rhat) == {"beta", "mu", "log_tau"}
    for name, streamed in post.full_rhat.items():
        torch.testing.assert_close(
            streamed, split_rhat(post.draws[name][:, ::rthin]), **TOL)


@pytest.mark.parametrize("algorithm", ["rwmh", "newton"])
def test_thin_keeps_every_thin_th_sweep(algorithm):
    """thin=3 retains sweeps 3, 6, 9, ... of the unthinned run from the
    same RNG (adaptation is off in sampling), bitwise, and its accept rates
    average over all the sweeps run."""
    data, _ = synth_logistic(4, G=7, n=6, p=2, device="cpu")
    model = make_hier_logistic(data, tau_prior="invgamma")
    common = dict(chains=4, warmup=15, seed=2, kernel={
        "algorithm": algorithm}, collect={"beta": None, "mu": None})
    thin = _run(model, data, draws=10, thin=3, segment_size=4, **common)
    unthinned = _run(model, data, draws=30, **common)
    for k in ("beta", "mu"):
        assert torch.equal(thin.draws[k], unthinned.draws[k][:, 2::3]), k
    torch.testing.assert_close(thin.accept_rates["beta"],
                               unthinned.accept_rates["beta"])


def test_log_rhat_flag_runs(es, caplog):
    logger = logging.getLogger("nestmc_torch")
    logger.propagate = True  # get_logger's logger does not propagate
    try:
        with caplog.at_level(logging.INFO, logger="nestmc_torch"):
            _run(*es, chains=4, warmup=10, draws=20, segment_size=10,
                 log=True, log_rhat=True, collect={"mu": None})
    finally:
        logger.propagate = False
    msgs = [r.getMessage() for r in caplog.records]
    assert any("worst split-rhat so far" in m for m in msgs)
    assert sum("sample:" in m for m in msgs) == 2


def _nan_model():
    def cond(name, value, state, data):
        return -0.5 * torch.sum(value * value, dim=-1)

    return ModelSpec(
        name="nan_start", blocks=(Block("x", (2,), init_scale=1.0),),
        cond_logdensity=cond,
        init_state=lambda rng, data, chains: {
            "x": torch.full((chains, 2), math.nan)},
    )


def test_debug_nans_raises_at_the_first_segment():
    """A NaN start stays NaN (NaN proposals are rejected): without
    debug_nans the run finishes, with it the first warmup segment
    raises."""
    data = {"_": torch.zeros(())}
    post = _run(_nan_model(), data, chains=3, warmup=8, draws=4,
                segment_size=4)
    assert bool(torch.isnan(post.draws["x"]).all())
    with pytest.raises(FloatingPointError, match="warmup segment ending at 4"):
        sample(_nan_model(), data, SamplerConfig(run=RunConfig(
            chains=3, warmup=8, draws=4, segment_size=4,
            log_every_segment=False)), debug_nans=True)


def test_posterior_helpers_match_reference(es):
    post = _run(*es, chains=4, warmup=30, draws=40, seed=2)
    jpost = JPosterior(
        draws={k: jnp.asarray(v.numpy()) for k, v in post.draws.items()},
        accept_rates={k: jnp.asarray(v.numpy())
                      for k, v in post.accept_rates.items()},
        warmup_accept_rates={}, config={})
    close = dict(rtol=1e-5, atol=1e-6)
    for name in ("mu", "theta"):
        np.testing.assert_allclose(post.mean(name).numpy(),
                                   np.asarray(jpost.mean(name)), **close)
        for ddof in (0, 1):
            np.testing.assert_allclose(post.var(name, ddof=ddof).numpy(),
                                       np.asarray(jpost.var(name, ddof)),
                                       **close)
        for q in (0.5, [0.05, 0.5, 0.95]):
            np.testing.assert_allclose(
                post.quantile(name, q).numpy(),
                np.asarray(jpost.quantile(name, jnp.asarray(q))), **close)
    got, want = post.summarize(), jpost.summarize()
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for k, v in want[name].items():
            np.testing.assert_allclose(got[name][k], np.asarray(v),
                                       rtol=1e-3, atol=1e-4,
                                       err_msg=f"{name} {k}")


def test_override_run_replaces_run_fields_only():
    """presets.override_run behaves as nestmc.presets.override_run."""
    from nestmc.config import KernelConfig as JKernelConfig
    from nestmc.config import RunConfig as JRunConfig
    from nestmc.config import SamplerConfig as JSamplerConfig
    from nestmc.presets import override_run as j_override_run
    from nestmc_torch.presets import override_run

    kw = {"draws": 7, "seed": 3, "collect": {"mu": None}}
    cfg = SamplerConfig(kernel=KernelConfig(algorithm="mala"),
                        run=RunConfig(chains=8, warmup=5))
    out = override_run(cfg, **kw)
    ref = j_override_run(JSamplerConfig(
        kernel=JKernelConfig(algorithm="mala"),
        run=JRunConfig(chains=8, warmup=5)), **kw)
    assert out.kernel == cfg.kernel and out.sharding == cfg.sharding
    assert cfg.run.draws == RunConfig().draws          # not changed in place
    for k, v in out.run.__dict__.items():
        assert getattr(ref.run, k) == v, k
    with pytest.raises(TypeError):
        override_run(cfg, no_such_field=1)


def test_warmup_then_state_is_the_adapted_carry(es):
    """engine.warmup_then_state runs the warmup only (draws=0, as the
    reference's) and returns its carry: a draws=0 run's final state, bit
    for bit, after warmup sweeps."""
    from nestmc_torch.engine import warmup_then_state

    model, data = es
    cfg = SamplerConfig(run=RunConfig(chains=4, warmup=30, draws=50,
                                      log_every_segment=False))
    st = warmup_then_state(model, data, cfg)
    assert st.t == 30
    ref = sample(model, data, SamplerConfig(run=RunConfig(
        chains=4, warmup=30, draws=0, log_every_segment=False)))
    for k, v in st.position.items():
        torch.testing.assert_close(v, ref.final_state.position[k], rtol=0,
                                   atol=0)
    for k, v in st.log_scale.items():
        torch.testing.assert_close(v, ref.final_state.log_scale[k], rtol=0,
                                   atol=0)
    # a run resumed from it with skip_warmup continues from the carry
    post = sample(model, data, cfg, init_state=st, skip_warmup=True)
    assert post.draws["mu"].shape == (4, 50)


def test_streaming_rhat_finalize_chain_axes():
    """Accumulators of a chains-minor leaf (beta (G, p, C): chain axis 2)
    pool to the same R-hat as the default layout's, given chain_axes."""
    from nestmc_torch.diagnostics import (
        streaming_rhat_finalize,
        streaming_rhat_init,
        streaming_rhat_update,
    )

    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 21, 5, 3, generator=g).cumsum(dim=1)
    acc = streaming_rhat_init({"beta": x[:, 0]})
    minor = streaming_rhat_init({"beta": x[:, 0].permute(1, 2, 0)})
    for j in range(21):
        acc = streaming_rhat_update(acc, {"beta": x[:, j]}, j, 10)
        minor = streaming_rhat_update(
            minor, {"beta": x[:, j].permute(1, 2, 0)}, j, 10)
    ref = streaming_rhat_finalize(acc)["beta"]
    out = streaming_rhat_finalize(minor, chain_axes={"beta": 2})["beta"]
    assert out.shape == (5, 3)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ref, split_rhat(x[:, :20]), rtol=2e-4,
                               atol=2e-4)
