"""The frozen yardstick: the bulk-ESS estimator, the kernels' work counts
and the reduction of a profiler trace."""

import numpy as np
import pytest
import torch

from portbench import ess, roofline, trace
from portbench.models import hier_logistic as HL


@pytest.mark.parametrize("rho", [0.0, 0.5, 0.9])
def test_ess_of_ar1_chains_is_n_1_minus_rho_over_1_plus_rho(rho):
    rng = np.random.default_rng(11)
    C, D = 64, 4000
    x = np.empty((C, D))
    x[:, 0] = rng.standard_normal(C) / np.sqrt(1 - rho ** 2)
    e = rng.standard_normal((C, D))
    for t in range(1, D):
        x[:, t] = rho * x[:, t - 1] + e[:, t]
    got = float(ess.ess_bulk(torch.tensor(x)[..., None])[0])
    want = C * D * (1 - rho) / (1 + rho)
    assert abs(got / want - 1) < 0.1, (got, want)


def test_ess_covers_every_scalar_in_row_major_order():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((8, 200, 3, 2)))
    x[:, :, 1, 0] = x[:, :, 1, 0].cumsum(1)     # a random walk: low ESS
    e = ess.ess_bulk(x)
    assert e.shape == (6,)
    assert int(e.argmin()) == 2


# PERF.md section 6: bytes of one call at the cells' shapes
@pytest.mark.parametrize("args,mb", [
    (("newton_step_frozen", 1024, 1000, 50, 4, True, True), 275.7),
    (("newton_step_frozen", 1024, 1000, 50, 4, False, True), 255.2),
    (("logp_grad", 1024, 1000, 50, 4), 38.1),
    (("mala_step", 512, 100000, 20, 3, False, False), 3316.8),
    (("logp_grad", 512, 100000, 20, 3), 1473.6),
])
def test_kernel_work_at_the_cells_shapes(args, mb):
    nbytes, _ = HL.kernel_work(*args)
    assert round(nbytes / 1e6, 1) == mb


def test_bounds_of_the_cells_kernels():
    # judged logp_grad is bound by its operations, mala_step by its bytes
    b, o = HL.kernel_work("logp_grad", 1024, 1000, 50, 4)
    assert roofline.bound_ms(b, o) == pytest.approx(0.0252, abs=1e-4)
    b, o = HL.kernel_work("mala_step", 512, 100000, 20, 3)
    assert roofline.bound_ms(b, o) == pytest.approx(0.9901, abs=1e-4)


@pytest.mark.parametrize("name,cat,call", [
    ("void nestmc::newton_step_kernel<nestmc::Logit, 4, true, true, false>"
     "(nestmc::NewtonArgs, int)", "kernels",
     ("newton_step_frozen", False, True)),
    ("void nestmc::mala_step_kernel<nestmc::Logit, 3, false, false>"
     "(nestmc::MalaArgs, int)", "kernels", ("mala_step", False, False)),
    ("void nestmc::logp_grad_kernel<nestmc::Logit, 4, false>(float const*)",
     "kernels", ("logp_grad", False, False)),
    ("void nestmc::logp_grad_kernel<nestmc::Logit, 4, true>(float const*)",
     "kernels", ("logp_grad_hess", False, False)),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096>)",
     "nccl", None),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "plain",
     None),
    ("Memcpy DtoD (Device -> Device)", "plain", None),
])
def test_device_names_are_told_apart(name, cat, call):
    assert roofline.classify(name, HL.HAND_WRITTEN) == cat
    if cat == "kernels":
        assert HL.kernel_call(name) == call


JUDGED = {"C": 1024, "G": 1000, "n": 50, "p": 4}
MALA_RANK = {"C": 256, "G": 50000, "n": 20, "p": 3}      # a 2 x 2 rank
MALA = {"C": 512, "G": 100000, "n": 20, "p": 3}          # one card


# (bytes, operations) of one launch: the step and likelihood kernels' as
# the counts gave them before they moved into the model's module; the
# interweaving move's as the program counts them (utils/profiling)
@pytest.mark.parametrize("algorithm,shapes,name,ordinal,work", [
    ("newton", JUDGED, "newton_step_kernel<nestmc::Logit, 4, true, true, "
     "false>", 0, (255184768, 2107392000)),
    ("newton", JUDGED, "newton_step_kernel<nestmc::Logit, 4, false, false, "
     "false>", 0, (165072768, 3610624000)),
    ("newton", JUDGED, "logp_grad_kernel<nestmc::Logit, 4, false>", 0,
     (38064000, 1689600000)),
    ("newton", JUDGED, "logp_grad_kernel<nestmc::Logit, 4, true>", 0,
     (79024000, 3225600000)),
    ("newton", JUDGED, "asis_stats_kernel<256>", 0, (73949184, 96256000)),
    ("newton", JUDGED, "asis_stats_kernel<256>", 1, (82141184, 96256000)),
    ("newton", JUDGED, "asis_propose_kernel<256>", 0, (33071104, 12888064)),
    ("newton", JUDGED, "asis_accept_kernel", 0, (319488, 600064)),
    ("mala", MALA_RANK, "mala_step_kernel<nestmc::Logit, 3, false, false>",
     0, (839206144, 8192000000)),
    ("mala", MALA_RANK, "logp_grad_kernel<nestmc::Logit, 3, false>", 0,
     (378400000, 7424000000)),
    ("mala", MALA_RANK, "asis_stats_kernel<512>", 0,
     (307235840, 755200000)),
    ("mala", MALA_RANK, "asis_stats_kernel<512>", 1,
     (409635840, 755200000)),
    ("mala", MALA_RANK, "asis_propose_kernel<256>", 0,
     (307251200, 115286016)),
    ("mala", MALA_RANK, "asis_accept_kernel", 0, (55296, 86016)),
    ("mala", MALA, "mala_step_kernel<nestmc::Logit, 3, false, false>", 0,
     (3316812288, 32768000000)),
    ("mala", MALA, "mala_step_kernel<nestmc::Logit, 3, true, true>", 0,
     (9051212288, 33996800000)),
    ("mala", MALA, "logp_grad_kernel<nestmc::Logit, 3, false>", 0,
     (1473600000, 29696000000)),
    ("mala", MALA, "asis_stats_kernel<512>", 0, (1228871680, 3020800000)),
    ("mala", MALA, "asis_stats_kernel<512>", 1, (1638471680, 3020800000)),
    ("mala", MALA, "asis_propose_kernel<256>", 0, (1228902400, 460972032)),
    ("mala", MALA, "asis_accept_kernel", 0, (110592, 172032)),
])
def test_the_models_counts_of_one_launch(algorithm, shapes, name, ordinal,
                                         work):
    full = f"void nestmc::{name}(float const*, int)"
    assert roofline.classify(full, HL.HAND_WRITTEN) == "kernels"
    got = HL.launch_work(full, ordinal, {"algorithm": algorithm}, shapes)
    assert got == work


def test_a_kernel_of_another_family_or_no_template_is_not_counted():
    cfg = {"algorithm": "mala"}
    for name in ("void nestmc::mala_step_kernel<nestmc::Poisson, 3, false, "
                 "false>(x)", "void nestmc::segment_kernel<nestmc::Logit, "
                 "3, true>(x)", "void nestmc::philox_fill_kernel(x)",
                 "void at::native::reduce_kernel<128, 4>(x)"):
        assert HL.launch_work(name, 0, cfg, MALA) is None, name


def _ev(name, device, start, end, corr, kind):
    return trace.Event(name, device, start, end, corr, kind)


def test_the_stretch_is_the_replayed_kernels_and_idle_is_what_they_leave():
    step = ("void nestmc::newton_step_kernel<nestmc::Logit, 4, true, true, "
            "false>(nestmc::NewtonArgs, int)")
    ev = [
        # the probe's eager kernels before the replays: not in the stretch
        _ev("aten::add", False, 0, 50, 1, "cpu_op"),
        _ev("void at::native::add_kernel", True, 10, 40, 2, "kernel"),
        # two replays, one sweep each
        _ev("cudaGraphLaunch", False, 100, 110, 7, "cuda_runtime"),
        _ev(step, True, 1000, 1600, 7, "kernel"),
        _ev("void at::native::mul_kernel", True, 1700, 1800, 7, "kernel"),
        _ev("nestmc.sample.seg0", True, 900, 3500, 9, "gpu_user_annotation"),
        _ev("cudaGraphLaunch", False, 1750, 2100, 8, "cuda_runtime"),
        _ev(step, True, 2200, 2800, 8, "kernel"),
        _ev("ncclDevKernel_AllReduce", True, 2800, 3000, 8, "kernel"),
        # the finalize after the replays
        _ev("void at::native::sqrt_kernel", True, 5000, 5100, 3, "kernel"),
    ]
    cfg = {"algorithm": "newton"}
    s = trace.summarize(ev, 1, lambda name, i: HL.launch_work(
        name, i, cfg, JUDGED), HL.HAND_WRITTEN)
    assert s.sweeps == 2
    assert s.stretch_s == pytest.approx(2000e-9)
    assert s.busy_s == pytest.approx(1500e-9)
    assert s.launches == {"kernels": 2, "plain": 1, "nccl": 1}
    assert s.seconds["kernels"] == pytest.approx(1200e-9)
    assert s.seconds["nccl"] == pytest.approx(200e-9)
    b, o = HL.kernel_work("newton_step_frozen", 1024, 1000, 50, 4,
                          fold=True)
    assert s.bound_s == pytest.approx(2 * roofline.bound_ms(b, o) * 1e-3)
    assert s.idle_gaps[0] == ["cudaGraphLaunch", pytest.approx(400e-9)]
    assert s.device_ops[0][0] == step


def test_no_replay_no_stretch():
    ev = [_ev("void k", True, 0, 10, 1, "kernel")]
    assert trace.summarize(ev, 1) is None


def test_each_launch_is_counted_by_its_ordinal_in_its_sweep():
    """Two replays of two sweeps each, each sweep with the move's two
    asis_stats launches: the first of each sweep is counted at the current
    point (0), the second at the proposal (1)."""
    stats = "void nestmc::asis_stats_kernel<256>(float const*, int)"
    ev = [_ev("cudaGraphLaunch", False, 0, 10, 7, "cuda_runtime"),
          _ev("cudaGraphLaunch", False, 20, 30, 8, "cuda_runtime")]
    t = 100
    for corr in (7, 8):
        for _ in range(4):
            ev.append(_ev(stats, True, t, t + 10, corr, "kernel"))
            t += 20
    seen = []
    s = trace.summarize(ev, 2, lambda name, i: seen.append(i) or (1e6, 0),
                        HL.HAND_WRITTEN)
    assert seen == [0, 1] * 4
    assert s.sweeps == 4 and s.launches["kernels"] == 8
    assert s.bound_s == pytest.approx(8 * roofline.bound_ms(1e6, 0) * 1e-3)
