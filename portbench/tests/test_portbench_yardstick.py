"""The frozen yardstick: the bulk-ESS estimator, the kernels' work counts
and the reduction of a profiler trace."""

import numpy as np
import pytest
import torch

from portbench import ess, roofline, trace


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
    nbytes, _ = roofline.kernel_work(*args)
    assert round(nbytes / 1e6, 1) == mb


def test_bounds_of_the_cells_kernels():
    # judged logp_grad is bound by its operations, mala_step by its bytes
    b, o = roofline.kernel_work("logp_grad", 1024, 1000, 50, 4)
    assert roofline.bound_ms(b, o) == pytest.approx(0.0252, abs=1e-4)
    b, o = roofline.kernel_work("mala_step", 512, 100000, 20, 3)
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
    assert roofline.classify(name) == cat
    if cat == "kernels":
        assert roofline.kernel_call(name) == call


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
    shapes = {"C": 1024, "G": 1000, "n": 50, "p": 4}
    s = trace.summarize(ev, 1, shapes)
    assert s.sweeps == 2
    assert s.stretch_s == pytest.approx(2000e-9)
    assert s.busy_s == pytest.approx(1500e-9)
    assert s.launches == {"kernels": 2, "plain": 1, "nccl": 1}
    assert s.seconds["kernels"] == pytest.approx(1200e-9)
    assert s.seconds["nccl"] == pytest.approx(200e-9)
    b, o = roofline.kernel_work("newton_step_frozen", 1024, 1000, 50, 4,
                                fold=True)
    assert s.bound_s == pytest.approx(2 * roofline.bound_ms(b, o) * 1e-3)
    assert s.idle_gaps[0] == ["cudaGraphLaunch", pytest.approx(400e-9)]
    assert s.device_ops[0][0] == step


def test_no_replay_no_stretch():
    ev = [_ev("void k", True, 0, 10, 1, "kernel")]
    assert trace.summarize(ev, 1, {"C": 1, "G": 1, "n": 1, "p": 1}) is None
