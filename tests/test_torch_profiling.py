"""The cost of one sweep (nestmc_torch/utils/profiling.py), the port of
``nestmc.utils.profiling.sweep_cost`` behind ``--cost-analysis``.

- sweep_cost returns exactly the reference's keys (held against the JAX
  package's XLA count at config 2's shape, keys only: the two count a
  transcendental differently; ``-s`` prints the ratio of their flops).
- Its kernel part is kernel_work summed over the launches one sweep
  records (each algorithm's, on padded and ragged data), and the two
  parts add up to the returned totals.
- flops_per_sweep grows linearly with the chains at fixed data.
- The count stops inside a kernel wrapper: a wrapper's plain version
  adds its kernel_work and nothing else.
- trace() writes a torch.profiler trace that holds the engine's segment
  spans under the reference's names (annotate).
"""

import json
import os

import numpy as np
import pytest
import torch

from nestmc_torch import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.data import from_numpy_ragged
from nestmc_torch.models import make_hier_logistic, synth_logistic
from nestmc_torch.ops import cuda
from nestmc_torch.ops.cuda.loglik_logistic import logistic_logp_grad
from nestmc_torch.presets import get_preset
from nestmc_torch.utils.profiling import (
    _Counter,
    count_sweep,
    kernel_work,
    sweep_cost,
    trace,
    trace_path,
)
from tests._torch_dist_worker import ragged_case
from tests.test_torch_calibration import one_thread  # noqa: F401

KEYS = {"flops_per_sweep", "bytes_per_sweep", "flops_per_sweep_per_chain",
        "arithmetic_intensity", "sol_sweeps_per_sec_hbm"}


def _cfg(alg, chains=8):
    return SamplerConfig(kernel=KernelConfig(algorithm=alg),
                         run=RunConfig(chains=chains,
                                       log_every_segment=False))


def test_keys_are_the_reference_keys():
    import jax

    from nestmc.presets import get_preset as j_get_preset
    from nestmc.utils.profiling import sweep_cost as j_sweep_cost

    jm, jd, jc = j_get_preset("hier-logistic-100", seed=0)
    ref = j_sweep_cost(jm, jd, jc, chains=8)
    m, d, c = get_preset("hier-logistic-100", seed=0, device="cpu")
    ours = sweep_cost(m, d, c, chains=8)
    assert set(ours) == set(ref) == KEYS
    assert all(np.isfinite(v) and v > 0 for v in ours.values())
    print(f"\nconfig 2 at 8 chains ({jax.default_backend()} XLA): port "
          f"flops {ours['flops_per_sweep']:.0f}, XLA "
          f"{ref['flops_per_sweep']:.0f}, ratio "
          f"{ours['flops_per_sweep'] / ref['flops_per_sweep']:.4f}; bytes "
          f"{ours['bytes_per_sweep']:.0f} vs {ref['bytes_per_sweep']:.0f}")


def _models():
    d, _ = synth_logistic(3, G=16, n=20, p=3, device="cpu")
    rd = from_numpy_ragged(*ragged_case(), device="cpu")
    return {"padded": (make_hier_logistic(d, tau_prior="invgamma"), d),
            "bucket": (make_hier_logistic(rd, loglik_impl="bucket"), rd),
            "segment": (make_hier_logistic(
                rd, loglik_impl="pallas-segment"), rd)}


@pytest.mark.parametrize("alg", ["newton", "mala", "rwmh"])
@pytest.mark.parametrize("route", ["padded", "bucket", "segment"])
def test_kernel_part_is_kernel_work_over_the_launches(route, alg):
    model, data = _models()[route]
    c = count_sweep(model, data, _cfg(alg))
    assert c["launches"]
    assert c["kernel_bytes"] == sum(kernel_work(*r)[0]
                                    for r in c["launches"])
    assert c["kernel_flops"] == sum(kernel_work(*r)[1]
                                    for r in c["launches"])
    for kernel, C, U, n, p, noise, fold in c["launches"]:
        assert kernel in cuda.LAUNCHES and C == 8 and not noise
    cost = sweep_cost(model, data, _cfg(alg))
    assert cost["flops_per_sweep"] == c["kernel_flops"] + c["plain_flops"]
    assert cost["bytes_per_sweep"] == c["kernel_bytes"] + c["plain_bytes"]


@pytest.mark.parametrize("route", ["padded", "bucket"])
def test_flops_are_linear_in_chains(route):
    """At fixed data the flops per sweep are a + b C with the same b
    between 8, 16 and 24 chains, and a (the few data-only ops of a
    sweep) under a thousandth of the total."""
    model, data = _models()[route]
    f = [sweep_cost(model, data, _cfg("newton"), chains=C)[
        "flops_per_sweep"] for C in (8, 16, 24)]
    assert f[2] - f[1] == f[1] - f[0]
    assert abs(2 * f[0] - f[1]) < 1e-3 * f[0]


def test_count_pauses_inside_a_wrapper():
    g = torch.Generator().manual_seed(0)
    beta = torch.randn(4, 6, 3, generator=g)
    x = torch.randn(6, 5, 3, generator=g)
    y = (torch.rand(6, 5, generator=g) < 0.5).float()
    mask = torch.ones(6, 5)
    counter = _Counter()
    prev, cuda.RECORDER = cuda.RECORDER, counter
    try:
        with counter:
            logistic_logp_grad(beta, x, y, mask)
    finally:
        cuda.RECORDER = prev
    assert counter.launches == [("logp_grad", 4, 6, 5, 3, False, False)]
    assert counter.flops == counter.bytes == 0


def test_trace_holds_the_engine_segment_spans(tmp_path):
    """A two-segment run (warmup and sampling) under trace(): the profile
    and the trace file written at exit hold nestmc.warmup.seg0/seg1 and
    nestmc.sample.seg0/seg1, the reference's span names."""
    from nestmc_torch import sample

    data, _ = synth_logistic(3, G=6, n=5, p=2, device="cpu")
    cfg = SamplerConfig(run=RunConfig(chains=4, warmup=4, draws=4,
                                      segment_size=2,
                                      log_every_segment=False))
    with trace(str(tmp_path), "run") as prof:
        sample(make_hier_logistic(data), data, cfg)
    want = {f"nestmc.{phase}.seg{i}" for phase in ("warmup", "sample")
            for i in (0, 1)}
    assert want <= {e.key for e in prof.key_averages()}
    path = trace_path(str(tmp_path), "run")
    assert os.path.exists(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert want <= names
    assert "nestmc.sample.seg2" not in names
