"""The compiled segment programs (nestmc_torch/segments.py) on the CPU.

The warmup sweep and the sampling draw run as steps on a static carry,
reading what changes from sweep to sweep from tables the host fills before
each segment: the Philox key words (SweepRNG.key_table), the Robbins-Monro
gains and the R-hat fold's and streamed update's scalars. These tests hold
the tables to the values the functional loop computed one sweep at a time,
and the static-carry steps, run eagerly here as sample() runs them on the
CPU, to that loop's bits on every path. tests/test_torch_cuda.py holds the
captured graphs to the eager steps on the card.
"""

import math

import numpy as np
import pytest
import torch

from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
from nestmc_torch.adapt import adapt_log_scale, precond_std, rm_step_size
from nestmc_torch.diagnostics import (
    fold_rhat_init,
    fold_rhat_scalars,
    fold_rhat_table,
    streaming_rhat_init,
    streaming_rhat_update,
)
from nestmc_torch.distributions import logpdf_normal
from nestmc_torch.kernels.gibbs import make_sweep, rhat_fold_names
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.model import Block, ModelSpec, vmap_chains
from nestmc_torch.models import (
    make_hier_glm,
    make_hier_logistic,
    make_nested_poisson,
    synth_glm,
    synth_logistic,
    synth_poisson3,
)
from nestmc_torch.presets import get_preset
from nestmc_torch.rng import SweepRNG
from nestmc_torch.segments import DrawProgram, WarmupProgram
from tests.test_torch_calibration import one_thread  # noqa: F401

W, D, SEG = 20, 20, 7      # sweeps, draws, steps a segment


def test_key_table_is_the_successive_philox_keys():
    a, b = SweepRNG(5, "cpu"), SweepRNG(5, "cpu")
    a.philox_key()
    b.philox_key()
    words = [a.philox_key() for _ in range(300)]
    table = b.key_table(300)
    assert table.dtype == torch.int32 and table.shape == (300, 2)
    got = table.numpy().view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(got, np.array(words, dtype=np.int64))
    assert torch.equal(a.host.get_state(), b.host.get_state())
    assert a.philox_key() == b.philox_key()


def test_key_words_hand_out_the_row_then_refuse():
    rng = SweepRNG(0, "cpu")
    row = rng.key_table(3)
    rng.use_keys(row)
    taken = [rng.key_words("cpu") for _ in range(3)]
    assert rng.keys_taken == 3
    assert all(t.data_ptr() == row[i].data_ptr() for i, t in enumerate(taken))
    with pytest.raises(RuntimeError, match="one more"):
        rng.key_words("cpu")


def test_rm_gain_table_is_rm_step_size_and_updates_bitwise():
    kcfg = KernelConfig()
    prog_tables = []
    model, data, cfg = _logistic("rwmh")
    state = init_kernel_state(model, cfg, SweepRNG(0, "cpu"), data)
    prog = WarmupProgram(make_sweep(model, cfg), state, data,
                         SweepRNG(0, "cpu"), cfg, 50, False, None)
    for n in (50, 50):
        prog_tables.append(prog._tables(n)["gain"])
    gains = torch.cat(prog_tables)
    want = torch.tensor([rm_step_size(t, kcfg) for t in range(100)],
                        dtype=torch.float32)
    assert torch.equal(gains, want)
    gen = torch.Generator().manual_seed(3)
    a = b = torch.randn(16, 9, generator=gen)
    for t in range(100):
        alpha = torch.rand(16, 9, generator=gen)
        a = adapt_log_scale(a, alpha, t, 0.234, kcfg)
        b = adapt_log_scale(b, alpha, t, 0.234, kcfg, gain=gains[t])
        assert torch.equal(a, b), t


@pytest.mark.parametrize("thin", [1, 3])
def test_fold_table_is_fold_rhat_scalars_every_draw(thin):
    # 25 draws a half: the half boundary falls inside the second segment
    model, data, cfg = _logistic("newton", thin=thin, draws=50)
    rng = SweepRNG(0, "cpu")
    state = init_kernel_state(model, cfg, rng, data)
    folds = rhat_fold_names(model, cfg)
    assert folds == ("beta",)
    half = (50 // cfg.run.full_rhat_thin) // 2
    fold_acc = fold_rhat_init(state.position, folds)
    std_acc = streaming_rhat_init({k: v for k, v in state.position.items()
                                   if k not in folds})
    prog = DrawProgram(make_sweep(model, cfg), state, data, rng, cfg,
                       std_acc, fold_acc, lambda pos: {}, 50, 0, half, 16,
                       False, None)
    rows = []
    for j0 in range(0, 50, 16):
        rows.append(prog._tables(min(16, 50 - j0), j0)["fold.beta"])
    rows = torch.cat(rows)
    count = torch.zeros(2)
    for j in range(50):
        sc = fold_rhat_scalars(count, j - 1 if j >= 1 else -1, half)
        assert torch.equal(rows[j], sc), j
        count = count + sc[:, 1]
    assert torch.equal(prog.counts["fold"]["beta"], count)
    assert prog.t == 50 * thin
    table, after = fold_rhat_table(torch.zeros(2), [j - 1 for j in range(50)],
                                   half)
    assert torch.equal(table[1:], rows[1:]) and torch.equal(after, count)


def test_full_precond_non_pd_gives_nan_not_a_raise():
    kcfg = KernelConfig(precond="full")
    cov = torch.eye(3).repeat(4, 2, 1, 1)
    cov[1, 0] = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0],
                              [0.0, 0.0, 1.0]])
    pc = {"mean": torch.zeros(4, 2, 3), "cov": cov,
          "count": torch.full((4,), 100.0)}
    L = precond_std(pc, kcfg)
    assert torch.isnan(L[1, 0]).all()
    ok = torch.ones(4, 2, dtype=torch.bool)
    ok[1, 0] = False
    assert torch.isfinite(L[ok]).all()
    want = torch.linalg.cholesky(cov[0, 0] + kcfg.precond_reg * torch.eye(3))
    assert torch.equal(L[0, 0], want)


# ---- the static-carry steps against the functional loop ----

def _logistic(algorithm, thin=1, draws=D, rthin=1, **model_kw):
    data, _ = synth_logistic(4, G=12, n=15, p=3, device="cpu")
    model = make_hier_logistic(data, **model_kw)
    return model, data, _cfg(algorithm, thin=thin, draws=draws, rthin=rthin)


def _cfg(algorithm=None, thin=1, draws=D, rthin=1, **kernel):
    kw = {} if algorithm is None else {"algorithm": algorithm}
    return SamplerConfig(
        kernel=KernelConfig(**kw, **kernel),
        run=RunConfig(chains=8, warmup=W, draws=draws, thin=thin,
                      full_rhat=True, full_rhat_thin=rthin,
                      segment_size=SEG, log_every_segment=False))


def _ragged(impl, algorithm):
    data, _ = synth_logistic(4, G=24, n=16, p=3, ragged=True, min_obs=1,
                             device="cpu")
    model = make_hier_logistic(data, tau_prior="invgamma", loglik_impl=impl)
    return model, data, _cfg(algorithm)


def _poisson(algorithm):
    data, _ = synth_poisson3(4, G=4, subjects_per_group=3, n=6, p=2,
                             device="cpu")
    return make_nested_poisson(data), data, _cfg(algorithm)


def _eight():
    model, data, cfg = get_preset("eight-schools", device="cpu")
    return model, data, _cfg(cfg.kernel.algorithm)


def _glm():
    data, _ = synth_glm(0, "gaussian", G=8, n=6, p=2, device="cpu")
    return make_hier_glm(data, family="gaussian"), data, _cfg("newton")


def _user():
    y = torch.tensor([0.4, 1.2, -0.3, 0.8, 1.5])

    def cond(name, v, s, d):
        return (logpdf_normal(d["y"], v, 1.0).sum()
                + logpdf_normal(v, 0.0, 2.0))

    model = vmap_chains(ModelSpec(
        name="tiny", blocks=(Block("theta", ()),), cond_logdensity=cond,
        init_state=lambda rng, d, c: {"theta": rng.normal(())}))
    return model, {"y": y}, _cfg("mala")


CASES = {
    "judged-newton": lambda: _logistic("newton", tau_prior="invgamma"),
    "mala": lambda: _logistic("mala"),
    "rwmh": lambda: _logistic("rwmh"),
    "mala-thin2-rhat-thin3": lambda: _logistic("mala", thin=2, rthin=3),
    "bucket-newton": lambda: _ragged("bucket", "newton"),
    "segment-mala": lambda: _ragged("pallas-segment", "mala"),
    "poisson-rwmh": lambda: _poisson("rwmh"),
    "poisson-mala": lambda: _poisson("mala"),
    "poisson-newton": lambda: _poisson("newton"),
    "eight-schools": _eight,
    "glm-gaussian": _glm,
    "vmap-chains": _user,
}


def _functional(model, data, cfg, seed):
    """The one-sweep-at-a-time loop the engine ran before the static
    carry: the gain from the host sweep count, the fold scalars and the
    streamed update from the host draw index."""
    rng = SweepRNG(seed, "cpu")
    sweep = make_sweep(model, cfg)
    state = init_kernel_state(model, cfg, rng, data)
    for _ in range(W):
        state = sweep(state, data, True, rng)
    folds = rhat_fold_names(model, cfg)
    std = streaming_rhat_init({k: v for k, v in state.position.items()
                               if k not in folds})
    fold = fold_rhat_init(state.position, folds)
    rthin = cfg.run.full_rhat_thin
    half = (D // rthin) // 2
    draws = {k: [] for k in state.position}
    for j in range(D):
        if folds:
            scs = {k: fold_rhat_scalars(fold[k][0], j - 1 if j else -1, half)
                   for k in folds}
            state, fout = sweep(state, data, False, rng,
                                {k: (fold[k][1], fold[k][2], scs[k])
                                 for k in folds})
            fold = {k: (fold[k][0] + scs[k][:, 1], *fout[k]) for k in folds}
        else:
            state = sweep(state, data, False, rng)
        for _ in range(cfg.run.thin - 1):
            state = sweep(state, data, False, rng)
        if j % rthin == 0:
            std = streaming_rhat_update(std, state.position, j // rthin,
                                        half)
        for k, v in state.position.items():
            draws[k].append(v.clone())
    return state, std, fold, {k: torch.stack(v, 1) for k, v in
                              draws.items()}, rng


def _static(model, data, cfg, seed):
    """The same run through the static-carry steps, segment by segment."""
    rng = SweepRNG(seed, "cpu")
    sweep = make_sweep(model, cfg)
    state = init_kernel_state(model, cfg, rng, data)
    warm = WarmupProgram(sweep, state, data, rng, cfg, SEG, False, None)
    for start in range(0, W, SEG):
        warm.run(min(SEG, W - start))
    state = warm.state()
    assert state.t == W
    folds = rhat_fold_names(model, cfg)
    std = streaming_rhat_init({k: v for k, v in state.position.items()
                               if k not in folds})
    fold = fold_rhat_init(state.position, folds)
    prog = DrawProgram(sweep, state, data, rng, cfg, std, fold,
                       lambda pos: dict(pos), D, 0,
                       (D // cfg.run.full_rhat_thin) // 2, SEG, False, None)
    for start in range(0, D, SEG):
        prog.run(min(SEG, D - start), start)
    std, fold = prog.acc()
    return prog.state(), std, fold, prog.draws, rng


def _equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif a is None:
        assert b is None, where
    else:
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=where)


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_carry_steps_are_the_functional_sweeps_bitwise(case):
    model, data, cfg = CASES[case]()
    f_state, f_std, f_fold, f_draws, f_rng = _functional(model, data, cfg, 3)
    s_state, s_std, s_fold, s_draws, s_rng = _static(model, data, cfg, 3)
    assert s_state.t == f_state.t
    for field in ("position", "log_scale", "accept_sum", "cache", "precond"):
        _equal(getattr(f_state, field), getattr(s_state, field), field)
    _equal(f_std, s_std, "std_acc")
    _equal(f_fold, s_fold, "fold_acc")
    _equal(f_draws, s_draws, "draws")
    assert torch.equal(f_rng.generator.get_state(),
                       s_rng.generator.get_state())


def test_sample_records_the_eager_loop_on_the_cpu():
    model, data, cfg = _logistic("newton")
    post = sample(model, data, cfg)
    assert post.timings["sweep"] == "eager"
    assert post.timings["capture_s"] == 0.0
    assert math.isfinite(post.worst_rhat())
